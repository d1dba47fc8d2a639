"""Fused functional ops (port of ``paddle_tpu.incubate.nn``)."""
