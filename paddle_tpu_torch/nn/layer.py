"""``nn.Layer``, the module base class (counterpart of
``paddle_tpu/nn/layer.py``).

A ``Layer`` is a ``torch.nn.Module`` with Paddle's surface: its
parameters are ``core.tensor.Parameter``s (``torch.nn.Parameter``s), so a
model built from these layers goes unchanged into the port's
``optimizer.AdamW``, ``jit.TrainStep`` (eager and captured), checkpoints
and ``monitor``. Paddle's names map onto the module's own storage
(``_sub_layers`` is ``_modules``); ``parameters()`` and ``buffers()``
return lists; ``state_dict()`` holds the live parameters and buffers
under the JAX package's structured names; ``register_forward_post_hook``
is torch's forward hook; ``to(dtype="bfloat16")`` casts the floating
parameters and buffers in place.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Tuple

import numpy as np
import torch
from torch.utils.hooks import RemovableHandle

from ..core.device import get_default_place, to_place
from ..core.dtype import convert_dtype, dtype_name
from ..core.tensor import Parameter, Tensor
from .initializer.api import _resolve_initializer

__all__ = ["Layer", "LayerList", "Sequential", "ParameterList", "LayerDict",
           "HookRemoveHelper", "swap_sublayers"]

HookRemoveHelper = RemovableHandle


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype_name(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter) and not value.name:
            value.name = f"{self._name_scope}.{name}"
        super().__setattr__(name, value)

    @property
    def _sub_layers(self):
        return self._modules

    # ------------------------------------------------------- registration

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.register_parameter(str(name), parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        """``persistable=False`` keeps the buffer out of ``state_dict``."""
        super().register_buffer(str(name), tensor, persistent=persistable)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        """A new ``Parameter`` of ``shape`` on the default place, drawn by
        the attribute's initializer (else ``default_initializer``, the
        global one, ``XavierUniform`` for a weight, zeros for a bias)."""
        dtype = convert_dtype(dtype or self._dtype)
        init = _resolve_initializer(attr, is_bias, default_initializer)
        data = init(tuple(int(s) for s in shape), dtype)
        name = None
        trainable = True
        if attr is not None and not isinstance(attr, (bool, str)):
            name = getattr(attr, "name", None)
            trainable = getattr(attr, "trainable", True)
        p = Parameter(data.to(get_default_place().device), trainable,
                      name=name)
        if attr is not None and not isinstance(attr, (bool, str)):
            p.optimize_attr["learning_rate"] = getattr(attr, "learning_rate",
                                                       1.0)
            p.regularizer = getattr(attr, "regularizer", None)
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        t = Tensor(np.zeros([0], np.float32), dtype=dtype or self._dtype)
        t.name = name or ""
        return t

    # ------------------------------------------------------- traversal

    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return list(super().parameters(recurse=include_sublayers))

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, *, recurse=None
                         ) -> Iterator[Tuple[str, Parameter]]:
        """(structured name, parameter) pairs; ``recurse`` is torch's name
        for ``include_sublayers``."""
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix, include_sublayers,
                                        remove_duplicate)

    def buffers(self, include_sublayers: bool = True) -> List[Tensor]:
        return list(super().buffers(recurse=include_sublayers))

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      remove_duplicate: bool = True, *, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_buffers(prefix, include_sublayers,
                                     remove_duplicate)

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        out = list(self.modules())
        return out if include_self else out[1:]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    # ------------------------------------------------------- state dict

    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix: str = "", keep_vars: bool = True):
        """The live parameters and persistable buffers by structured name
        (``layers.0.linear1.weight``). torch's keyword form
        (``prefix=``, ``keep_vars=``) is taken too."""
        if destination is None:
            destination = collections.OrderedDict()
        prefix = structured_name_prefix or prefix
        if not include_sublayers:
            for n, p in self._parameters.items():
                if p is not None:
                    destination[prefix + n] = p if keep_vars else p.detach()
            for n, b in self._buffers.items():
                if b is not None and n not in \
                        self._non_persistent_buffers_set:
                    destination[prefix + n] = b if keep_vars else b.detach()
            return destination
        return super().state_dict(destination=destination, prefix=prefix,
                                  keep_vars=keep_vars)

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy every matching entry of ``state_dict`` (tensors or numpy
        arrays) into this layer's state in place; returns ``(missing,
        unexpected)`` keys. A shape mismatch raises ``ValueError``."""
        own = self.state_dict()
        missing, unexpected = [], []
        for name, tgt in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            shape = tuple(src.shape) if hasattr(src, "shape") \
                else np.shape(src)
            if tuple(shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {name}: checkpoint "
                                 f"{tuple(shape)} vs model {tuple(tgt.shape)}")
            with torch.no_grad():
                torch.Tensor.copy_(tgt, torch.as_tensor(
                    src.detach() if isinstance(src, torch.Tensor)
                    else np.asarray(src)))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ------------------------------------------------------- dtype/device

    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device=, dtype=)`` with Paddle's device strings and dtype
        names (floating parameters and buffers only change type), or
        torch's ``Module.to`` arguments."""
        if isinstance(device, str) and device.split(":")[0] not in (
                "cpu", "gpu", "cuda", "tpu", "xpu"):
            device, dtype = None, device          # to("bfloat16")
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        dev = None if device is None else to_place(device).device
        dt = None if dtype is None else convert_dtype(dtype)
        if dt is not None:
            self._dtype = dtype_name(dt)
            for layer in self.sublayers():
                if isinstance(layer, Layer):
                    layer._dtype = self._dtype
        if dev is not None and dt is not None:
            return super().to(dev, dt, **kwargs)
        if dev is not None:
            return super().to(dev, **kwargs)
        if dt is not None:
            return super().to(dt, **kwargs)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # ------------------------------------------------------- hooks / misc

    def register_forward_post_hook(self, hook) -> RemovableHandle:
        """``hook(layer, inputs, output)``; a returned value replaces the
        output."""
        return self.register_forward_hook(hook)

    def full_name(self):
        return self._name_scope

    def clear_gradients(self, set_to_zero: bool = False):
        for p in self.parameters():
            p.clear_gradient(set_to_zero)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        n = len(self._modules)
        return self._modules[str(idx + n if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
            return
        for i, layer in enumerate(layers):
            if isinstance(layer, (tuple, list)) and len(layer) == 2:
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)
        return self


def swap_sublayers(model, fn):
    """Rewrite a layer tree: ``fn(layer)`` returns a replacement or None to
    recurse; the root is offered first."""
    replaced = fn(model)
    if replaced is not None:
        return replaced
    for name, child in list(model.named_children()):
        new_child = fn(child)
        if new_child is not None:
            setattr(model, name, new_child)
        else:
            swap_sublayers(child, fn)
    return model
