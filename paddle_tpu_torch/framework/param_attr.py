"""``ParamAttr``, after ``paddle_tpu/framework/param_attr.py``: how a layer
builds one parameter (its name, initializer, learning-rate factor,
regularizer, whether it trains and whether the global clip sees it).
``Layer.create_parameter`` reads it.
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, a ``ParamAttr`` or ``False`` as given; a string is a name;
        anything else an initializer."""
        if attr is None or isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)
