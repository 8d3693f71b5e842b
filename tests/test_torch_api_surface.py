"""Every public name of each JAX module the Paddle-surface slice ports is
present in the port's counterpart, or listed in ``LEFT_FOR_LATER`` with
the ROADMAP item that holds it. A module's public names are its
``__all__``, or where it has none the public functions and classes it
defines itself."""
import importlib
import inspect
import os

import pytest

import paddle_tpu  # noqa: F401  (the JAX package, on the CPU)
import paddle_tpu_torch

ITEM11 = "ROADMAP Queue 1, item 11 (jit.to_static and the JAX tape)"
ITEM4_RULES = "ROADMAP Queue 1, item 4's rest (DGC and LARS update rules)"
ITEM10 = "ROADMAP Queue 1, item 10's rest (LocalSGD averages across ranks)"

# JAX module -> port module
PORTED = {
    "core.flags": "core.flags",
    "core.dtype": "core.dtype",
    "core.device": "core.device",
    "core.tensor": "core.tensor",
    "core.dispatch": "core.dispatch",
    "core.autograd": "core.autograd",
    "autograd": "autograd",
    "ops.creation": "ops.creation",
    "ops.math": "ops.math",
    "ops.manipulation": "ops.manipulation",
    "ops.logic": "ops.logic",
    "ops.linalg": "ops.linalg",
    "param_attr": "param_attr",
    "nn.initializer.api": "nn.initializer.api",
    "nn.layer": "nn.layer",
    "nn.functional.activation": "nn.functional.activation",
    "nn.functional.loss": "nn.functional.loss",
    "nn.functional.common": "nn.functional.common",
    "nn.functional.norm": "nn.functional.norm",
    "nn.functional.attention": "nn.functional.attention",
    "nn.functional.conv": "nn.functional.conv",
    "nn.functional.pooling": "nn.functional.pooling",
    "nn.layers_common": "nn.layers_common",
    "nn.layers_conv_pool": "nn.layers_conv_pool",
    "nn.layers_norm_act_loss": "nn.layers_norm_act_loss",
    "nn.layers_transformer": "nn.layers_transformer",
    "nn.layers_rnn": "nn.layers_rnn",
    "nn.layers_extended": "nn.layers_extended",
    "nn.functional.extended": "nn.functional.extended",
    "optimizer.optimizer": "optimizer.optimizer",
    "framework.io": "framework.io",
    "vision": "vision",
    "vision.models.resnet": "vision.models.resnet",
    "vision.models.lenet": "vision.models.lenet",
    "vision.models.vgg": "vision.models.vgg",
    "vision.models.alexnet": "vision.models.alexnet",
    "vision.models.mobilenetv2": "vision.models.mobilenetv2",
    "io.dataset": "io.dataset",
    "io.sampler": "io.sampler",
    "io.dataloader": "io.dataloader",
    "io.bucketing": "io.bucketing",
    "io.device_loader": "io.device_loader",
    "metric": "metric",
    "hapi.model": "hapi.model",
    "hapi.callbacks": "hapi.callbacks",
    "hapi.async_metrics": "hapi.async_metrics",
    "distributed.fleet.meta_optimizer_wrappers":
        "distributed.fleet.meta_optimizer_wrappers",
}

# the JAX package's TPU names, spelled for the card in the port
RENAMED = {"core.device": {"TPUPlace": "CUDAPlace",
                           "is_compiled_with_tpu": "is_compiled_with_cuda"}}

LEFT_FOR_LATER = {
    "core.dispatch": {
        "TraceContext": ITEM11, "in_trace": ITEM11, "push_trace": ITEM11,
        "pop_trace": ITEM11, "trace_ctx": ITEM11, "record_bwd_call": ITEM11},
    "distributed.fleet.meta_optimizer_wrappers": {
        "DGCOptimizer": ITEM4_RULES, "LarsMomentumOptimizer": ITEM4_RULES,
        "LocalSGDOptimizer": ITEM10},
}


def public_names(mod):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


@pytest.mark.parametrize("jax_mod,port_mod", sorted(PORTED.items()))
def test_ported_module_names(jax_mod, port_mod):
    """JAX names minus the port's = exactly the module's LEFT_FOR_LATER."""
    j = importlib.import_module(f"paddle_tpu.{jax_mod}")
    t = importlib.import_module(f"paddle_tpu_torch.{port_mod}")
    renamed = RENAMED.get(jax_mod, {})
    missing = {n for n in public_names(j)
               if not hasattr(t, renamed.get(n, n))}
    assert missing == set(LEFT_FOR_LATER.get(jax_mod, {}))


def test_left_for_later_names_their_roadmap_items():
    text = open(os.path.join(os.path.dirname(__file__), os.pardir,
                             "ROADMAP.md")).read()
    for names in LEFT_FOR_LATER.values():
        for item in names.values():
            assert item.startswith("ROADMAP Queue 1, item ")
            number = item.split("item ")[1].split("'")[0].split(" ")[0]
            assert f"Item {number}" in text or f"item {number}" in text


@pytest.mark.parametrize("namespace,modules", [
    ("", ["ops.creation", "ops.math", "ops.manipulation", "ops.logic",
          "core.tensor", "core.flags"]),
    ("linalg", ["ops.linalg"]),
    ("nn", ["nn.layers_common", "nn.layers_conv_pool",
            "nn.layers_norm_act_loss", "nn.layers_transformer", "nn.layer",
            "nn.layers_rnn", "nn.layers_extended"]),
    ("nn.functional", ["nn.functional.activation", "nn.functional.loss",
                       "nn.functional.common", "nn.functional.norm",
                       "nn.functional.attention", "nn.functional.conv",
                       "nn.functional.pooling", "nn.functional.extended"]),
    ("nn.initializer", ["nn.initializer.api"]),
    ("optimizer", ["optimizer.optimizer"]),
    ("vision", ["vision"]),
    ("vision.models", ["vision.models.resnet", "vision.models.lenet",
                       "vision.models.vgg", "vision.models.alexnet",
                       "vision.models.mobilenetv2"]),
    ("io", ["io.dataset", "io.sampler", "io.dataloader", "io.bucketing",
            "io.device_loader"]),
    ("metric", ["metric"]),
    ("hapi", ["hapi.model", "hapi.async_metrics"]),
    ("callbacks", ["hapi.callbacks"])],
    ids=["paddle", "linalg", "nn", "functional", "initializer", "optimizer",
         "vision", "models", "io", "metric", "hapi", "callbacks"])
def test_namespaces_export_the_ported_names(namespace, modules):
    """``import paddle_tpu_torch as paddle`` reads like the JAX package:
    each namespace exports what its ported modules hold (``wrap_outputs``
    and the helper functions stay in their modules)."""
    ns = paddle_tpu_torch
    for part in filter(None, namespace.split(".")):
        ns = getattr(ns, part)
    skip = {"wrap_outputs", "define_flag", "flag", "calculate_fan",
            "HookRemoveHelper", "swap_sublayers", "Initializer"}
    for jax_mod in modules:
        j = importlib.import_module(f"paddle_tpu.{jax_mod}")
        left = set(LEFT_FOR_LATER.get(jax_mod, {}))
        missing = {n for n in public_names(j) - left - skip
                   if not hasattr(ns, n)}
        assert not missing, f"{namespace or 'paddle'} lacks {missing}"


def test_top_level_surface():
    p = paddle_tpu_torch
    for name in ("to_tensor", "Tensor", "Parameter", "float32", "bfloat16",
                 "int64", "bool", "set_device", "get_device", "CUDAPlace",
                 "CPUPlace", "grad", "no_grad", "save", "load", "ParamAttr",
                 "seed", "set_flags", "get_flags", "linalg", "autograd"):
        assert hasattr(p, name), name
    assert hasattr(p.nn, "Layer") and hasattr(p.optimizer, "SGD")
    assert hasattr(p.optimizer, "Momentum") and hasattr(p.optimizer, "Lamb")
    assert hasattr(p.nn, "LSTM") and hasattr(p.nn.functional, "ctc_loss")
    assert hasattr(p.nn.functional, "interpolate") and hasattr(p.nn, "Fold")
    assert hasattr(p.vision.models, "resnet50") and hasattr(p.nn, "Conv2D")
    assert p.Model is p.hapi.Model and hasattr(p.io, "DeviceLoader")
    assert hasattr(p.metric, "Accuracy") and hasattr(p.callbacks,
                                                     "AutoCheckpoint")
    assert hasattr(p.distributed.fleet, "GradientMergeOptimizer")


def test_the_surface_imports_no_jax():
    """Importing the port with its whole Paddle surface pulls in neither
    jax nor the JAX package (a fresh interpreter)."""
    import subprocess
    import sys
    code = ("import sys, paddle_tpu_torch as p\n"
            "import paddle_tpu_torch.nn, paddle_tpu_torch.ops.linalg\n"
            "import paddle_tpu_torch.autograd, paddle_tpu_torch.framework.io\n"
            "import paddle_tpu_torch.vision.models\n"
            "import paddle_tpu_torch.io, paddle_tpu_torch.metric\n"
            "import paddle_tpu_torch.hapi, paddle_tpu_torch.callbacks\n"
            "import paddle_tpu_torch.distributed.fleet"
            ".meta_optimizer_wrappers\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
