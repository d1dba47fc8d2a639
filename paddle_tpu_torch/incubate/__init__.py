"""Incubating fused ops (port of ``paddle_tpu.incubate``)."""
