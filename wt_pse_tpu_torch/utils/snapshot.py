"""Run-directory code snapshot (counterpart of ``wt_pse_tpu/utils/snapshot.py``).

As the reference's ``save_code`` (``utils.py:48-57``): the package's source and
the resolved hparams as YAML go into ``out_dir/code``, so a run can be
reproduced from its own directory. ``yaml`` is imported only to write the
config.
"""

from __future__ import annotations

import os
import shutil


def save_code(out_dir: str, hparams: dict | None = None,
              extra_files: list[str] | None = None) -> str:
    """Copy ``wt_pse_tpu_torch/`` and ``config_resolved.yaml`` into
    ``out_dir/code``; returns that directory."""
    import wt_pse_tpu_torch

    code_dir = os.path.join(out_dir, "code")
    pkg_root = os.path.dirname(os.path.abspath(wt_pse_tpu_torch.__file__))
    dst_pkg = os.path.join(code_dir, "wt_pse_tpu_torch")
    if os.path.exists(dst_pkg):
        shutil.rmtree(dst_pkg)
    shutil.copytree(pkg_root, dst_pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    for f in extra_files or []:
        if os.path.exists(f):
            shutil.copy2(f, code_dir)
    if hparams is not None:
        import yaml

        with open(os.path.join(code_dir, "config_resolved.yaml"), "w") as fh:
            yaml.safe_dump(dict(hparams), fh)
    return code_dir
