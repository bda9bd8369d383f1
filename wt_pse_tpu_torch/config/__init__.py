from wt_pse_tpu_torch.config.hparams import ALGORITHMS, JOINT, default_hparams
from wt_pse_tpu_torch.config.loader import Config, argv_update, load_config

__all__ = ["ALGORITHMS", "JOINT", "Config", "argv_update", "default_hparams", "load_config"]
