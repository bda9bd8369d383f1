from wt_pse_tpu_torch.config.hparams import ALGORITHMS, default_hparams

__all__ = ["ALGORITHMS", "default_hparams"]
