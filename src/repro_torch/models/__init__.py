"""Model zoo of the port (dense decoder path so far)."""

from .lm import LM, Block, RunCfg, init_params, param_count

__all__ = ["LM", "Block", "RunCfg", "init_params", "param_count"]
