"""The port's whitening losses (``wt_pse_tpu_torch/ops/whitening.py``) reproduce
every ``whitening/*`` entry of ``tests/goldens.json`` at its own tolerance class.

The golden inputs are ``np.random.RandomState(42)`` draws
(``tests/test_goldens.py:52-56,95``), rebuilt here without JAX and handed to the
port in NCHW. ``whitening/dom_mmd_f64`` is computed in float64 through the port,
as its class says.
"""

import json
import os

import numpy as np
import pytest
import torch

from wt_pse_tpu_torch.ops.whitening import (domain_mmd, instance_whitening_terms,
                                            main_whitening_loss,
                                            student_whitening_loss,
                                            upper_triangle_vectors)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.json")
with open(GOLDENS) as _f:
    _FROZEN = json.load(_f)
TOL = {k: tuple(v) for k, v in _FROZEN["meta"]["tolerances"].items()}
NAMES = sorted(k for k in _FROZEN["values"] if k.startswith("whitening/"))
B, HW, DOMAINS, PDB = 9, 16, 3, 3


def _feats(dtype):
    rng = np.random.RandomState(42)
    feats = [rng.randn(B, HW, HW, 16).astype(np.float32) * s for s in (0.5, 0.8, 1.1)]
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))).to(dtype)
            for f in feats]


@pytest.fixture(scope="module")
def port_values():
    feats = _feats(torch.float32)
    out = {}
    for quirks in (True, False):
        tag = "quirks" if quirks else "clean"
        inst, dom = main_whitening_loss(feats, DOMAINS, PDB, 0.0, quirks)
        out[f"whitening/main_inst_{tag}"] = inst
        out[f"whitening/main_dom_{tag}"] = dom
        tot, off, diag, sdom = student_whitening_loss(feats, DOMAINS, PDB, 0.0, quirks)
        out[f"whitening/stud_total_{tag}"] = tot
        out[f"whitening/stud_off_{tag}"] = off
        out[f"whitening/stud_diag_{tag}"] = diag
        out[f"whitening/stud_dom_{tag}"] = sdom
    out["whitening/main_inst_margin2"] = main_whitening_loss(feats, DOMAINS, PDB, 2.0, True)[0]
    out["whitening/dom_mmd_f64"] = main_whitening_loss(
        _feats(torch.float64), DOMAINS, PDB, 0.0, True)[1]
    return {k: (float(v), v.dtype) for k, v in out.items()}


@pytest.mark.parametrize("name", NAMES)
def test_whitening_golden(port_values, name):
    rec = _FROZEN["values"][name]
    rtol, atol = TOL[rec["tol"]]
    value, dtype = port_values[name]
    assert dtype == (torch.float64 if rec["tol"] == "f64" else torch.float32)
    assert np.isclose(value, rec["value"], rtol=rtol, atol=atol), (
        f"{name}: port {value!r} vs golden {rec['value']!r} (class {rec['tol']})")


def test_upper_triangle_is_row_major():
    cov = torch.arange(16.0).reshape(1, 4, 4)
    assert upper_triangle_vectors(cov).tolist() == [[1.0, 2.0, 3.0, 6.0, 7.0, 11.0]]


def test_single_domain_mmd_is_zero():
    assert float(domain_mmd(torch.ones(4, 6), 1, 4)) == 0.0


def test_instance_terms_of_identity_are_zero():
    off, diag = instance_whitening_terms(torch.eye(16).expand(3, 16, 16))
    assert float(off) == 0.0 and float(diag) == 0.0
