"""ParamAttr (counterpart of ``paddle_tpu/param_attr.py``)."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    """A parameter's name, initializer, learning-rate scale, regularizer
    and trainability, as ``Layer.create_parameter`` reads them."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)
