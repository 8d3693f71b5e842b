"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package does the same work on
an NVIDIA H100. Plain tensor code is PyTorch, and every Pallas kernel of
the JAX package on a ported path is a hand-written Hopper kernel
(``kernels/``, CUDA sources in ``csrc/``), built with ``nvcc`` at first
use. Entry points run on the GPU unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.

Ported so far: GPT inference and training at its dropout
(``models.GPTForCausalLM``: attention through the packed flash-attention
forward and backward kernels with in-kernel dropout, the dropout kernel,
the loss), BERT pretraining (``models.BertForPreTraining``: the pair
kernels bidirectional at head_dim 64, the fused add-dropout-LayerNorm
kernels, MLM + NSP losses), LLaMA inference and training
(``models.LlamaForCausalLM``: RoPE, RMSNorm, SwiGLU, grouped-query
attention through the ``[B, L, H, D]`` flash kernels), ``optimizer.AdamW``
with fp32 masters, ``jit.TrainStep`` (eager steps), and the serving
engine over GPT or LLaMA (``serving.DecodeEngine``: paged or row cache,
speculative decoding with three drafters, int8 weight-only serving through
``quantization.Int8Linear``; its steps CUDA graphs on the card). Every dropout draws
its seed from the model's CPU generator and its bits from one Philox
stream keyed on the element, so the card and the CPU drop the same
elements. ``seed``, ``get_rng_state`` and ``set_rng_state`` drive the
global chain that ``F.dropout``, ``nn.Dropout`` and the attention
functionals draw from when no generator is given (``core/random.py``).
``convert.load_paddle_state`` carries weights over from a ``paddle_tpu``
model. Training takes the JAX package's single-card knobs: activation
recompute on GPT and LLaMA (``recompute_granularity`` "full", "dots" or
"selective", ``distributed.fleet.recompute``), gradient accumulation and
a ``GradScaler`` in ``TrainStep``, ``nn.ClipGradBy*`` as ``grad_clip``,
``regularizer.L2Decay`` and AdamW's ``apply_decay_param_fun``, and
``amp.auto_cast`` / ``amp.decorate``; ``TrainStep.save_checkpoint`` /
``load_checkpoint`` / ``rollback_last_commit`` checkpoint a run on one card
(``distributed.checkpoint``, with ``distributed.preemption`` for
SIGTERM). ``monitor`` is the telemetry plane
(metrics, JSONL records, spans, goodput and MFU, model health), wired into
``TrainStep`` and ``DecodeEngine``; ``PADDLE_MONITOR=path`` turns it on at
import.

The Paddle dygraph surface (slice 19): ``import paddle_tpu_torch as
paddle`` reads like the JAX package: ``paddle.to_tensor``, ``Tensor`` (a
``torch.Tensor`` subclass), ``Parameter``, the dtypes, ``set_device`` /
``get_device`` / ``CUDAPlace``, ``grad``, ``no_grad``, the ops of
``ops`` (also ``Tensor`` methods), ``linalg``, ``nn`` (``Layer``, a
``torch.nn.Module``, and its layers up to ``TransformerEncoder``),
``nn.functional``, ``autograd.PyLayer``, ``optimizer.SGD`` /
``Momentum`` / ``Adam`` / ``AdamW``, ``save`` / ``load``, ``ParamAttr``,
``set_flags`` / ``get_flags``. Every op passes ``core.dispatch.apply_op``.

Convolution, pooling and the batch norms (slice 20): ``nn.Conv*D`` and
their transposes, the max, average and adaptive pools, ``BatchNorm*`` /
``SyncBatchNorm`` (one process), ``GroupNorm``, ``InstanceNorm*``,
``LocalResponseNorm`` and their functionals, torch / cuDNN ops (XLA ops
in the JAX package: no kernel of its is on this path), and ``vision``
(``vision.models``: ResNet-18 to -152, the ResNeXt and wide ResNets,
LeNet, VGG, AlexNet, MobileNetV2). ``FLAGS_cudnn_deterministic`` sets
``torch.backends.cudnn.deterministic``.

hapi and io (slice 21): ``paddle.Model`` (``prepare`` / ``fit`` /
``evaluate`` / ``predict``, eager or through ``TrainStep`` with
``jit_compile`` / ``accumulate_steps``), ``callbacks`` (``AutoCheckpoint``
among them), ``metric``, and ``io``: datasets, samplers, the
``DataLoader`` (batches collated on the host) and the ``DeviceLoader``
(host-to-card copies on a side stream ahead of the step;
``stack_batches=K`` for accumulation); ``distributed.fleet.
GradientMergeOptimizer`` sets ``TrainStep``'s accumulation.

The rest of nn and the optimizers (slice 22): ``nn.functional.
interpolate`` / ``upsample`` (the JAX package's resize), ``unfold`` /
``fold`` and their layers, the recurrent layers (``nn.SimpleRNN``,
``LSTM``, ``GRU``, their cells, ``RNN`` / ``BiRNN``), the extended
functionals and layers (CTC and RNN-T losses, ``grid_sample``, the
unpools, ``SpectralNorm``, ``dynamic_decode``), and ``optimizer.Adamax``
/ ``Adagrad`` / ``Adadelta`` / ``RMSProp`` / ``Lamb``, every rule staged
(``TrainStep`` captures it) and scaled by each parameter's
``ParamAttr(learning_rate=...)``.
"""
import builtins

from . import (amp, autograd, core, distributed, framework, io, jit,
               kernels, metric, models, monitor, nn, ops, optimizer,
               quantization, regularizer, serving, utils, vision)
from . import callbacks, hapi
from .core.autograd import grad
from .core.device import (CPUPlace, CUDAPlace, Place, device_count,
                          get_device, is_compiled_with_cuda, set_device)
from .core.dispatch import (enable_grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtype import (bfloat16, bool_ as bool, complex64,  # noqa: F401
                         complex128, float16, float32, float64, int8,
                         int16, int32, int64, uint8)
from .core.flags import get_flags, set_flags
from .core.random import get_rng_state, seed, set_rng_state
from .core.tensor import Parameter, Tensor, to_tensor
from .hapi import Model
from .jit import TrainStep
from .models import (BertConfig, BertForPreTraining, GPTConfig,
                     GPTForCausalLM, LlamaConfig, LlamaForCausalLM, bert_base,
                     llama_7b)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .ops import linalg
from .param_attr import ParamAttr
from .serving import DecodeEngine

save = framework.io.save
load = framework.io.load

_default_dtype = ["float32"]


def get_default_dtype():
    return _default_dtype[0]


def set_default_dtype(d):
    """Record the default floating type's name (read back by
    ``get_default_dtype``; layers keep float32 parameters, as the JAX
    package's do)."""
    from .core.dtype import dtype_name
    _default_dtype[0] = dtype_name(d)


def disable_static(place=None):
    """Eager is the only mode: nothing to do."""


def enable_static():
    raise NotImplementedError(
        "the port is eager; static graphs (jit.to_static) are ROADMAP "
        "Queue 1, item 11")


def in_dynamic_mode():
    return True


def is_grad_enabled_():
    return is_grad_enabled()


def summary(net, input_size=None, dtypes=None):
    """Print and return the parameter counts of ``net``."""
    total = builtins.sum(p.numel() for p in net.parameters())
    trainable = builtins.sum(p.numel() for p in net.parameters()
                             if p.requires_grad)
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    return {"total_params": total, "trainable_params": trainable}


__all__ = (["amp", "autograd", "core", "distributed", "framework", "io",
            "jit", "kernels", "metric", "models", "monitor", "nn", "ops",
            "optimizer", "quantization", "regularizer", "serving", "utils",
            "vision", "linalg", "callbacks", "hapi", "Model",
            "BertConfig", "BertForPreTraining", "bert_base", "GPTConfig",
            "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM", "llama_7b",
            "DecodeEngine", "TrainStep", "seed", "get_rng_state",
            "set_rng_state", "grad", "CPUPlace", "CUDAPlace", "Place",
            "device_count", "get_device", "is_compiled_with_cuda",
            "set_device", "enable_grad", "is_grad_enabled", "no_grad",
            "set_grad_enabled", "bool", "bfloat16", "complex64",
            "complex128", "float16", "float32", "float64", "int8", "int16",
            "int32", "int64", "uint8", "get_flags", "set_flags", "Parameter",
            "Tensor", "to_tensor", "ParamAttr", "save", "load",
            "get_default_dtype", "set_default_dtype", "disable_static",
            "enable_static", "in_dynamic_mode", "is_grad_enabled_",
            "summary"]
           + [n for n in _ops_all if n != "linalg"])

monitor._maybe_enable_from_env()
