"""``paddle.grad`` and the backward entry (counterpart of
``paddle_tpu/core/autograd.py``).

The JAX package walks its own tape of ``GradNode``s; the port's tape is
torch autograd's graph, whose nodes (``torch.autograd.graph.Node``) are
``GradNode`` here. ``run_backward`` is ``torch.autograd.backward`` and
``grad`` is ``torch.autograd.grad`` with Paddle's arguments:
``create_graph=True`` records the backward for a second derivative,
``retain_graph`` defaults to ``create_graph`` (Paddle's rule), and
``allow_unused=True`` gives None for an input the outputs do not reach.
"""
from __future__ import annotations

import torch

from .tensor import wrap_outputs

__all__ = ["GradNode", "run_backward", "grad"]

GradNode = torch.autograd.graph.Node


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def run_backward(tensors, grad_tensors=None, retain_graph: bool = False,
                 create_graph: bool = False):
    """Accumulate the gradients of ``tensors`` (seeded with
    ``grad_tensors``, ones for a scalar) into every reached leaf's
    ``.grad``."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph,
                            create_graph=create_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False, no_grad_vars=None):
    """``paddle.grad``: d(outputs)/d(inputs) as a list of ``Tensor``s (None
    for an unreached input under ``allow_unused``), leaving every
    ``.grad`` alone."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    try:
        grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=allow_unused)
    except RuntimeError as e:
        if "not have been used in the graph" in str(e):
            raise RuntimeError(
                "one of the inputs has no gradient path from outputs (pass "
                "allow_unused=True to get None)") from e
        raise
    return [None if g is None else wrap_outputs(g) for g in grads]
