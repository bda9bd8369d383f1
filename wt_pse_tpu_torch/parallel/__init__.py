"""Data-parallel training across processes and the leave-one-out sweep launcher
(counterpart of ``wt_pse_tpu/parallel/``)."""
