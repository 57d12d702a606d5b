"""The port's measurement tools (``dgl_tpu_torch/tools``) against the JAX
package's on the CPU, and ``chip_smoke.py``'s search for the package.

* ``perf_bitgat_probe``'s tiny check (``bitgat_fwd_t``'s plain version on
  P2's tiny inputs) against P2's ``make_fwd`` with ``_arrange`` and
  ``_unarrange`` (``tools/perf_bitgat_probe.py:78-134``), interpreted:
  rtol 1e-5 / atol 1e-5, f32 on both sides with the sums over each dst's
  edges in another order;
* ``perf_bitmm_variants``'s tiny check (K1's plain version) against P1's
  ``make_swapped`` with its body ``_k_v5`` and ``make`` with ``_k_v0``
  (``tools/perf_bitmm_variants.py:41-58, 103-119, 148-205``), interpreted
  at the tiny size by setting the module's ``KP`` and ``N32``: ``_k_v5``
  keeps each plane scaled by its bit's value (the scale "folded outside",
  undone here), x is f32 on both sides, rtol 1e-5 / atol 1e-4.

No file of the JAX package's ``tools/`` changes: the tests load them by
path and patch their module globals.
"""
import importlib.util
import os
import shutil
import subprocess
import sys
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest

from dgl_tpu_torch.tools import perf_bitgat_probe as tp2
from dgl_tpu_torch.tools import perf_bitmm_variants as tp1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bitgat_probe_tiny_matches_oracle():
    out, err = tp2.tiny_check("cpu")
    assert out.shape == (tp2.TINY_N, tp2.H, tp2.D) and err < 1e-5


def test_bitgat_probe_tiny_matches_jax_make_fwd():
    """The port's tiny check against P2's kernel, interpreted, on the same
    inputs and packing (no repacking: P2 and ``bitgat_fwd_t`` read one
    orientation)."""
    j = _jax_tool("perf_bitgat_probe")
    assert (j.H, j.D, j.SLOPE) == (tp2.H, tp2.D, tp2.SLOPE)
    a, pt, el, er, z = tp2.tiny_inputs()
    got, _ = tp2.tiny_check("cpu")
    fn = j.make_fwd(tp2.TINY_S_PAD, tp2.TINY_K_PAD // 32, 512, 128,
                    interpret=True)
    elc, erp, zt = j._arrange(jnp.asarray(el), jnp.asarray(er),
                              jnp.asarray(z), tp2.TINY_S_PAD, tp2.TINY_K_PAD,
                              jnp.float32)
    out_t, _ = fn(jnp.asarray(pt), elc, erp, zt)
    want = np.asarray(j._unarrange(out_t, tp2.TINY_N))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bitmm_variants_tiny_matches_oracle():
    out, err = tp1.tiny_check("cpu")
    assert out.shape == (tp1.TINY_N, tp1.F) and err < 1e-4


@pytest.mark.parametrize("variant", ["v5_swapped", "v0_planes"])
def test_bitmm_variants_tiny_matches_jax(monkeypatch, variant):
    """The port's tiny check against P1's variants, interpreted at the tiny
    size: ``_k_v5`` through ``make_swapped`` (output (32, N32, F), each
    plane scaled by 2^b, the sign bit's by -2^31) and ``_k_v0`` through
    ``make`` (output (32, F, N32), 0/1 planes)."""
    j = _jax_tool("perf_bitmm_variants")
    assert j.F_PAD == tp1.F
    n32 = tp1.TINY_N // 32
    monkeypatch.setattr(j, "KP", tp1.TINY_KP)
    monkeypatch.setattr(j, "N32", n32)
    packed, x = tp1.tiny_inputs()
    got, _ = tp1.tiny_check("cpu")
    xt = jnp.asarray(x.T)
    if variant == "v5_swapped":
        out = np.asarray(j.make_swapped(j._k_v5, 256, 64, interpret=True)(
            jnp.asarray(packed), xt), np.float64)
        scale = np.array([np.int32(np.uint32(1) << np.uint32(b)).item()
                          for b in range(32)], np.float64)
        want = (out / scale[:, None, None]).reshape(32 * n32, tp1.F)
    else:
        out = np.asarray(j.make(j._k_v0, 256, 64, interpret=True)(
            jnp.asarray(packed), xt))
        want = out.transpose(0, 2, 1).reshape(32 * n32, tp1.F)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _holds_package(path):
    path = os.path.abspath(path)
    while True:
        if os.path.isfile(os.path.join(path, "dgl_tpu_torch", "__init__.py")):
            return True
        if os.path.dirname(path) == path:
            return False
        path = os.path.dirname(path)


def test_chip_smoke_finds_the_package_from_a_copy(tmp_path, monkeypatch):
    """A copy of chip_smoke.py outside the checkout finds the package from
    the working directory, and a copy inside it from its own directory;
    where neither leads to the package, the search raises, and a lone copy
    exits with an error and prints no result."""
    copy = tmp_path / "lone" / "chip_smoke.py"
    copy.parent.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    spec = importlib.util.spec_from_file_location("_chip_smoke_copy", copy)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.package_root(str(copy), ROOT) == ROOT
    inner = os.path.join(ROOT, "tests", "lone", "chip_smoke.py")
    assert mod.package_root(inner, copy.parent) == ROOT
    # a name no directory holds: the search ends at the file system's root
    monkeypatch.setattr(mod, "PACKAGE", "dgl_tpu_torch_absent")
    with pytest.raises(SystemExit, match="no dgl_tpu_torch_absent"):
        mod.package_root(str(copy), ROOT)
    with mock.patch.object(mod.torch.cuda, "is_available", return_value=True):
        monkeypatch.chdir(copy.parent)
        with pytest.raises(SystemExit, match="no dgl_tpu_torch_absent"):
            mod.main()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(copy)], cwd=copy.parent,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert '"ok"' not in res.stdout
    if not _holds_package(copy.parent):
        assert res.returncode != 0
        assert "no dgl_tpu_torch/__init__.py" in res.stderr or \
            "no CUDA device" in res.stderr
