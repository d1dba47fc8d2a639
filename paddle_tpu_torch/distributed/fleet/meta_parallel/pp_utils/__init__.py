"""Pipeline helpers (after upstream Paddle's ``meta_parallel/pp_utils``):
the point-to-point channel between stages."""
from .p2p_communication import LocalChannel, P2PChannel  # noqa: F401

__all__ = ["P2PChannel", "LocalChannel"]
