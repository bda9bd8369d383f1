"""The port's native eval operators (``wt_pse_tpu_torch/native`` +
``csrc/evalops.cpp``) against the port's scipy paths, on the CPU.

- largest component + fill holes: bitwise the scipy path's, ties included;
- the EDT within 1e-5 relative (1e-4 absolute) of scipy's f64 one, inf on
  an empty mask; surface distances, ASD and HD95 at the same tolerance (the
  engine works in f32);
- the dispatch: ``scoring_backend`` resolves 'auto' to native here; a build
  that fails raises ``NativeUnavailable`` with the compiler's reason where
  native is asked for, is not retried, and 'auto' then reports scipy with
  the reason kept;
- four processes that build into one empty directory at once all load one
  whole library, and no temporary file is left.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.ndimage as ndi

from wt_pse_tpu_torch import native
from wt_pse_tpu_torch.ops import metrics as M
from wt_pse_tpu_torch.ops import postprocess as PP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blobs(seed, hw=96, n=5):
    r = np.random.RandomState(seed)
    m = np.zeros((hw, hw), bool)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for _ in range(n):
        cy, cx = r.randint(8, hw - 8, 2)
        rad = r.randint(3, 14)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    return m


@pytest.mark.parametrize("seed", range(4))
def test_largest_component_fill_holes_is_the_scipy_path(seed):
    m = _blobs(seed)
    m[40:43, 40:43] = False  # a hole, if a blob covers it
    m |= np.random.RandomState(seed).rand(*m.shape) > 0.97  # specks
    got = native.largest_component_fill_holes_native(m)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, PP.largest_component_fill_holes_scipy(m))
    np.testing.assert_array_equal(PP.largest_component_fill_holes(m, backend="native"), got)
    tie = np.zeros((10, 10), np.uint8)
    tie[1:3, 6:8] = tie[6:8, 1:3] = 1
    np.testing.assert_array_equal(native.largest_component_fill_holes_native(tie),
                                  PP.largest_component_fill_holes_scipy(tie))


def test_edt_matches_scipy():
    for seed in range(3):
        m = _blobs(seed, hw=64, n=3)
        np.testing.assert_allclose(native.edt_native(m), ndi.distance_transform_edt(~m),
                                   rtol=1e-5, atol=1e-4)
    assert np.isinf(native.edt_native(np.zeros((16, 16), bool))).all()


@pytest.mark.parametrize("seed", range(3))
def test_surface_metrics_match_scipy(seed):
    a = _blobs(seed, hw=72, n=2)
    b = np.roll(_blobs(seed + 10, hw=72, n=2), 3, axis=1)
    np.testing.assert_allclose(M.surface_distances(a, b, backend="native"),
                               M.surface_distances(a, b, backend="scipy"), rtol=1e-5, atol=1e-4)
    for fn in (M.asd, M.assd, M.hd95):
        assert fn(a, b, backend="native") == pytest.approx(fn(a, b, backend="scipy"),
                                                           rel=1e-5, abs=1e-4)
    with pytest.raises(ValueError, match="empty"):
        M.hd95(np.zeros_like(a), b, backend="native")


def test_auto_resolves_to_native_and_names_are_checked():
    assert native.scoring_backend("auto") == "native"
    assert native.scoring_backend("scipy") == "scipy"
    assert native.unavailable_reason() is None
    with pytest.raises(ValueError, match="scoring backend"):
        native.scoring_backend("fast")


def test_a_failed_build_raises_and_is_not_swallowed(tmp_path, monkeypatch):
    bad = tmp_path / "evalops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(native.NativeUnavailable, match="failed"):
        native.scoring_backend("native")
    bad.write_text('extern "C" int f() { return 0; }\n')  # the failure is remembered
    with pytest.raises(native.NativeUnavailable):
        native.load()
    with pytest.raises(native.NativeUnavailable):
        M.hd95(_blobs(0), _blobs(1), backend="native")
    assert native.scoring_backend("auto") == "scipy"
    assert "failed" in native.unavailable_reason()
    assert not list((tmp_path / "build").glob("*.so")) and not list((tmp_path / "build").glob("*.tmp"))


def test_four_processes_build_into_one_empty_directory_at_once(tmp_path):
    build_dir, go = tmp_path / "native", tmp_path / "go"
    code = textwrap.dedent(f"""
        import os, time
        import numpy as np
        from wt_pse_tpu_torch import native
        native.BUILD_DIR = native.Path({str(build_dir)!r})
        while not os.path.exists({str(go)!r}):
            time.sleep(0.005)
        m = np.zeros((9, 9), bool)
        m[2:7, 2:7] = True
        m[4, 4] = False
        assert native.largest_component_fill_holes_native(m).sum() == 25
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["ok"] * 4
    assert [p.name for p in build_dir.iterdir() if p.suffix != ".lock"] == \
        [native.library_path().name]
