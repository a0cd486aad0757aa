"""The roofline path of the port (kernels/roof.py, models/bench_states.py,
roofline.py) against the JAX package's harness.

On the CPU the kernel wrappers take their plain PyTorch versions; the
kernels themselves are held to those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. Tolerances:

* the copy (K6, K6b, K6c): within 1 ULP of the Pallas copy kernel in
  interpret mode, because XLA's CPU backend contracts ``x * s + 1e-12``
  into one fused multiply-add (one rounding) where the port, as eager
  PyTorch and its CUDA kernel, rounds the product and the sum apart; and
  bit for bit against that twice-rounded value computed in numpy;
* the chained-``exp`` probe: rtol 1e-6 at float32 and 1e-13 at float64
  (torch and XLA:CPU ``exp`` differ by an ULP or so per link, and the
  chain's map x -> exp(-x) contracts errors by at most 1/e per link);
* the benchmark state: bit for bit against ``__graft_entry__._build``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cloudmicrophysics_tpu_torch import perf, roofline
from cloudmicrophysics_tpu_torch.kernels import roof as R
from cloudmicrophysics_tpu_torch.models import bench_states

REPO = Path(__file__).resolve().parents[1]
# the body of the Pallas copy kernel in each of its three sites
COPY_BODY = "oref[...] = iref[...] * sref[0, 0] + 1e-12"
COPY_SITES = ("benchmarks/roofline.py", "benchmarks/scratch/perf_roof.py",
              "benchmarks/scratch/perf_roof2.py")


def _pallas_copy(x, s, nf, ncol, nlev, bc):
    """``copy_kernel``/``copy_step`` of benchmarks/roofline.py:118-128 (the
    kernel is nested in ``main()``), with ``interpret=True`` to run on the
    CPU and ``s`` the scale itself, as K6b passes it."""
    def copy_kernel(sref, iref, oref):
        oref[...] = iref[...] * sref[0, 0] + 1e-12

    def copy_step(x, s, bc=128):
        spec = pl.BlockSpec((nf, bc, nlev), lambda i: (0, i, 0))
        sspec = pl.BlockSpec((1, 1), lambda i: (0, 0))
        return pl.pallas_call(
            copy_kernel, grid=(ncol // bc,),
            in_specs=[sspec, spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(jnp.full((1, 1), s, x.dtype), x)

    return copy_step(x, s, bc)


def test_copy_body_is_the_pallas_kernels():
    """The test below reproduces the Pallas body: fail when a site changes."""
    for site in COPY_SITES:
        assert COPY_BODY in (REPO / site).read_text(), site


@pytest.mark.parametrize("case", ["K6", "K6b", "K6c"])
def test_copy_plain_matches_pallas_copy(case):
    nf, ncol, nlev = 7, 64, 16
    rng = np.random.default_rng(11)
    x = (np.ones((nf, ncol, nlev)) if case == "K6c"
         else 1e-2 * rng.random((nf, ncol, nlev))).astype(np.float32)
    if case == "K6":
        # benchmarks/roofline.py: jnp.full((1, 1), 1.0 + 1e-7 * s) of a
        # float32 s, so the scale is rounded where the JAX program rounds it
        s_j = 1.0 + 1e-7 * jnp.float32(37.0)
        s_t = R.scale_of(37.0)
        assert np.float32(s_j) == s_t.numpy()
    else:
        # perf_roof.py / perf_roof2.py: jnp.float32(1.0 + 1e-6 * i)
        s_j = jnp.float32(1.0 + 1e-6 * 23)
        s_t = torch.tensor(1.0 + 1e-6 * 23, dtype=torch.float32)
    want = np.asarray(_pallas_copy(jnp.asarray(x), s_j, nf, ncol, nlev, 16))
    got = R.copy_step(torch.from_numpy(x), s_t).numpy()
    assert got.dtype == np.float32
    # XLA:CPU fuses the multiply and the add (one rounding): 1 ULP
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # the port rounds the product, then the sum, as the eager step does
    twice = x * s_t.numpy() + np.float32(1e-12)
    np.testing.assert_array_equal(got, twice)
    # the plain version is the CPU path of the wrapper, out= included
    out = torch.empty(x.shape)
    assert R.copy_step(torch.from_numpy(x), s_t, out=out) is out
    np.testing.assert_array_equal(out.numpy(), twice)


def test_copy_refuses_an_output_that_overlaps_its_input():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="overlaps"):
        R.copy_step(x, 2.0, out=x)
    with pytest.raises(ValueError, match="overlaps"):
        R.copy_step(x[:6], 2.0, out=x[4:])
    with pytest.raises(ValueError, match="shape"):
        R.copy_step(x, 2.0, out=torch.empty(9))


def _jax_exp_chain(x, s):
    """``exp_chain`` of benchmarks/roofline.py:150-154."""
    x = x * (1.0 + 1e-7 * s)
    for _ in range(R.CHAIN):
        x = jnp.exp(-x)          # self-map, stays in [e^-1, 1]
    return x


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-13)])
def test_exp_chain_plain_matches_jax(dtype, rtol):
    rng = np.random.default_rng(5)
    x = np.concatenate([np.full(64, 0.5), rng.uniform(0.0, 3.0, 192)])
    x = x.astype(dtype)
    want = np.asarray(jax.jit(_jax_exp_chain)(jnp.asarray(x),
                                              jnp.asarray(9.0, dtype)))
    got = R.exp_chain_step(torch.from_numpy(x), 9.0)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    assert np.all((want >= np.exp(-1.0) * (1 - rtol)) & (want <= 1.0))


def test_exp_chain_length_and_scale():
    x = torch.tensor([0.25, 2.0], dtype=torch.float64)
    np.testing.assert_array_equal(R.exp_chain_step(x, 4.0, chain=0).numpy(),
                                  (x * (1 + 4e-7)).numpy())
    np.testing.assert_array_equal(
        R.exp_chain_plain(x, 0.0, chain=2).numpy(),
        torch.exp(-torch.exp(-x)).numpy())
    with pytest.raises(ValueError):
        R.exp_chain_step(x, 0.0, chain=-1)


def test_bench_state_is_the_graft_entry_state():
    from __graft_entry__ import _build

    _, want = _build(ncol=64, nlev=16, dtype=jnp.float32)
    got = bench_states.device_state(64, 16, "cpu")
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_uniform_states():
    st2 = bench_states.uniform_state_2m(3, 2, "cpu")
    st3 = bench_states.uniform_state_p3(3, 2, "cpu")
    for st, values in ((st2, bench_states.UNIFORM_2M),
                       (st3, bench_states.BENCH_P3)):
        assert len(st) == len(values)
        for t, v in zip(st, values):
            assert t.shape == (3, 2) and t.dtype == torch.float32
            assert bool((t == np.float32(v)).all())


def test_seeded_bench_states():
    """The random 2M and the jittered P3 states: float32, seeded (the same
    seed gives the same state, another seed another), within their
    recipes' ranges."""
    st2 = bench_states.device_state_2m(8, 4, "cpu", seed=3)
    want = [np.float32(a) for a in bench_states.state_recipe_2m(8, 4, 3)]
    for name, a, b in zip(st2._fields, st2, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    st3 = bench_states.p3_bench_state(8, 4, "cpu", seed=3)
    again = bench_states.p3_bench_state(8, 4, "cpu", seed=3)
    other = bench_states.p3_bench_state(8, 4, "cpu", seed=4)
    assert all(bool((a == b).all()) for a, b in zip(st3, again))
    assert not bool((st3.q_ice == other.q_ice).all())
    assert float(st3.rho[0, 0]) == np.float32(1.2)
    assert float(st3.T[0, -1]) == np.float32(250.0)
    for t, v in zip(st3[2:], bench_states.BENCH_P3[2:]):
        assert t.dtype == torch.float32
        assert bool((t >= np.float32(0.5 * v)).all())
        assert bool((t <= np.float32(1.5 * v)).all())


def test_roofline_rows_on_the_cpu(capsys):
    rows = roofline.main(["--device", "cpu", "--ncol", "32", "--nlev", "8",
                          "--p3-ncol", "2", "--p3-nlev", "4"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
    tpu = [json.loads(line) for line in
           (REPO / "benchmarks/ROOFLINE_TPU.json").read_text().splitlines()]
    assert [r["metric"] for r in rows] == [r["metric"] for r in tpu]
    for row, ref in zip(rows, tpu):
        assert set(ref) <= set(row), row["metric"]
        assert row["device"] == "cpu"
        assert row["card"] is None and row["power_limit"] is None
        # every field only the card can give is null on the CPU
        for key in ("ms_per_step", "achieved_GBps", "exp_per_s",
                    "fraction_of_copy_roof", "fraction_of_hbm_datasheet",
                    "wall", "exp_equivalents_per_point_budget"):
            assert row.get(key) is None, (row["metric"], key)
    by = {r["metric"]: r for r in rows}
    assert by["dma_copy_roof"]["bytes_per_step"] == 2 * 7 * 32 * 8 * 4
    assert by["vpu_exp_rate"]["unit"] == "expf on the SMs"
    assert by["vpu_exp_rate"]["elements"] == 32 * 8
    assert by["1m_step_pallas_packed"]["analytic_bytes_per_step"] \
        == 14 * 4 * 32 * 8
    assert by["p3_column_step"]["analytic_bytes_per_step"] == 12 * 4 * 2 * 8
    assert by["p3_column_step"]["batch"] == [2, 4]
    assert by["p3_column_step"]["quadrature_order"] == 16


def test_roofline_wall_label():
    row = roofline._row("x", 1e-3, 1e-3, 10, int(0.7e9), 1e12, 3.35e12)
    assert row["fraction_of_copy_roof"] == pytest.approx(0.7)
    assert row["wall"] == "hbm"
    assert roofline._row("x", 1e-3, 1e-3, 10, int(0.69e9), 1e12,
                         3.35e12)["wall"] == "sm"


def test_hbm_rate_by_card_name():
    assert perf.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert perf.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert perf.hbm_bytes_per_s("NVIDIA H100 NVL") == 3.9e12
    assert perf.hbm_bytes_per_s("NVIDIA A100-SXM4-40GB", 1.555e12) \
        == 1.555e12
    with pytest.raises(ValueError, match="no data sheet"):
        perf.hbm_bytes_per_s("NVIDIA A100-SXM4-40GB")


def test_roofline_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        roofline.main(["--ncol", "32", "--nlev", "8"])
