"""FNO configurations of the port (own copy of the reference's FNO fields)."""
from repro_torch.configs.base import FNOConfig, PrecisionPolicy
from repro_torch.configs.fno import (FNO_IDS, get_config, with_block_plan,
                                     with_fuse_block, with_fuse_ends,
                                     with_precision, with_tp_layout)

__all__ = ["FNOConfig", "PrecisionPolicy", "FNO_IDS", "get_config",
           "with_block_plan", "with_fuse_block", "with_fuse_ends",
           "with_precision", "with_tp_layout"]
