"""Model zoo of the port: every block of the reference's zoo, on one
device or on a mesh (``RunCfg.mesh``)."""

from .lm import LM, Block, RunCfg, init_params, param_count

__all__ = ["LM", "Block", "RunCfg", "init_params", "param_count"]
