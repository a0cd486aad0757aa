"""The port's ARG-activation emulators (the MLP, the GP and the boosted
oblivious trees) and their training-data pipelines against the JAX
package, on the CPU.

Tolerances:

* ``emulator_features`` and ``generate_training_data`` (64 samples, the
  same numpy draws, float64): rtol 1e-9.
* ``generate_parcel_training_data`` (8 members, 2 s): the port's float32
  parcel ensemble against JAX's float32 ``vmap``, rtol 1e-5 on the
  features and both labels.
* ``mlp_params_from_flax`` and the forward pass, float32: rtol 1e-6.
* 20 full-batch Adam steps from the converted flax initialization,
  float32: rtol 1e-4 on the loss and on every weight (optax and
  ``torch.optim.Adam`` take the same update in another order).
* The GP at n = 256, float32: predictions rtol 1e-4 (the float32
  Cholesky solve of a kernel matrix with noise 1e-2 magnifies rounding
  differences; measured 1.3e-5).
* The trees at n = 512, 20 trees, depth 4: features and thresholds exact
  (the first minimum of the same float64 scores), leaves rtol 1e-9. The
  fit buckets samples by float64 compares against float64 candidates, as
  the JAX fit does, and stores float32 thresholds; no training sample of
  this dataset (nor of the 2048 of the 300 x depth-5 gate fit) changes
  bucket under the float32 thresholds. The forest's
  prediction on converted parameters: rtol 1e-6 within two float32
  epsilons (its 20 float32 leaves summed in another order; measured
  8.9e-8).
* ``N_activated_per_mode_emulated`` for each family on the JAX package's
  fitted parameters, converted: rtol 1e-5.
* The port's own fits are held to the RMSE and activation gates of
  ``tests/test_calibration.py`` on the same datasets (2048 training and
  2048 validation samples, the MLP on the first 512).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import emulator as JE
from cloudmicrophysics_tpu.parameters import aerosol as JA
from cloudmicrophysics_tpu_torch.models import emulator as TE
from cloudmicrophysics_tpu_torch.ops import aerosol_activation as TAA
from cloudmicrophysics_tpu_torch.parameters import aerosol as TA

CPU = "cpu"
ATOL_SUM = 2 * float(np.finfo(np.float32).eps)
JARGS = (JA.AerosolActivationParameters(), JP.AirProperties(),
         JP.ThermodynamicsParameters())
TARGS = (TA.AerosolActivationParameters(), TP.AirProperties(),
         TP.ThermodynamicsParameters())
STATES = [(1e8, 5e8, 5e-8, 1.0, 290.0, 9e4),
          (5e7, 2e8, 8e-8, 0.5, 283.0, 8.5e4),
          (3e8, 1e8, 4e-8, 2.0, 295.0, 9.5e4)]


def _mode(pkg, N, r):
    return pkg.ModeKappa(r_dry=r, stdev=2.0, N=N, vol_mix_ratio=(1.0,),
                         mass_mix_ratio=(1.0,), molar_mass=(0.13214,),
                         kappa=(0.53,))


def _dist(pkg, N1, N2, r):
    return pkg.AerosolDistribution(modes=(_mode(pkg, N1, r),
                                          _mode(pkg, N2, r)))


@pytest.fixture(scope="module")
def data():
    """The port's datasets of tests/test_calibration.py: 2048 training
    samples (seed 1) and 2048 validation samples (seed 2)."""
    return (TE.generate_training_data(*TARGS, n_samples=2048, seed=1,
                                      device=CPU),
            TE.generate_training_data(*TARGS, n_samples=2048, seed=2,
                                      device=CPU))


@pytest.fixture(scope="module")
def jax_fits(data):
    """The JAX package's three families, fitted small, on the same data."""
    (X, y), _ = data
    mlp = JE.train_emulator(X[:256], y[:256], n_steps=20)
    gp = JE.train_emulator_gp(X[:256], y[:256])
    trees = JE.train_emulator_trees(X[:512], y[:512], n_trees=20, depth=4)
    return {"mlp": mlp, "gp": gp, "trees": trees}


def _bucket_changes(X, params, n_thresholds=15):
    """Training samples whose bucket at some split differs between the
    fit's float64 compare against the float64 candidate and inference's
    float32 compare against the stored float32 threshold."""
    f = params["features"].numpy()
    thr32 = params["thresholds"].numpy()
    cand = np.quantile(X, np.linspace(0, 1, n_thresholds + 2)[1:-1], axis=0)
    # the float64 candidate of each split: its feature's candidate that
    # rounds to the stored threshold
    k = np.argmax(cand[:, f].astype(np.float32) == thr32[None], axis=0)
    thr64 = cand[k, f]
    assert np.array_equal(thr64.astype(np.float32), thr32)
    x = X[:, f]                                            # (n, T, D)
    return int(np.any((x > thr64) != (x.astype(np.float32) > thr32),
                      axis=(1, 2)).sum())


class TestData:
    def test_features(self):
        rng = np.random.default_rng(5)
        modes = [dict(N=10 ** rng.uniform(7, 9, 16),
                      r=10 ** rng.uniform(-8, -7, 16),
                      s=rng.uniform(1.4, 2.4, 16),
                      k=rng.uniform(0.1, 1.2, 16)) for _ in range(2)]
        w, T, p = (rng.uniform(0.1, 2, 16), rng.uniform(270, 300, 16),
                   rng.uniform(7e4, 1e5, 16))

        def dist(pkg, A):
            return pkg.AerosolDistribution(modes=tuple(
                pkg.ModeKappa(r_dry=A(m["r"]), stdev=A(m["s"]), N=A(m["N"]),
                              vol_mix_ratio=(1.0,), mass_mix_ratio=(1.0,),
                              molar_mass=(0.13214,), kappa=(A(m["k"]),))
                for m in modes))

        want = JE.emulator_features(dist(JA, jnp.asarray), JARGS[0],
                                    jnp.asarray(w), jnp.asarray(T),
                                    jnp.asarray(p))
        got = TE.emulator_features(dist(TA, torch.as_tensor), TARGS[0],
                                   torch.as_tensor(w), torch.as_tensor(T),
                                   torch.as_tensor(p))
        assert got.dtype == torch.float64 and got.shape == (16, 11)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
        # numbers only: one float64 feature vector
        one = TE.emulator_features(_dist(TA, 1e8, 5e8, 5e-8), TARGS[0], 1.0,
                                   290.0, 9e4)
        ref = JE.emulator_features(_dist(JA, 1e8, 5e8, 5e-8), JARGS[0], 1.0,
                                   290.0, 9e4)
        assert one.dtype == torch.float64 and one.shape == (11,)
        np.testing.assert_allclose(one.numpy(), np.asarray(ref), rtol=1e-9)

    def test_training_data(self):
        Xj, yj = JE.generate_training_data(*JARGS, n_samples=64, seed=1)
        Xt, yt = TE.generate_training_data(*TARGS, n_samples=64, seed=1,
                                           device=CPU)
        assert isinstance(Xt, np.ndarray) and Xt.shape == (64, 11)
        np.testing.assert_allclose(Xt, Xj, rtol=1e-9)
        np.testing.assert_allclose(yt, yj, rtol=1e-9)

    def test_parcel_training_data(self):
        kw = dict(n_samples=8, seed=3, t_end=2.0, dt=0.2,
                  return_arg_labels=True)
        want = JE.generate_parcel_training_data(*JARGS, **kw)
        got = TE.generate_parcel_training_data(*TARGS, device=CPU, **kw)
        assert len(got) == 3 and got[0].shape == (8, 11)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5)
        X, y = TE.generate_parcel_training_data(*TARGS, n_samples=8, seed=3,
                                                t_end=2.0, dt=0.2,
                                                device=CPU)
        np.testing.assert_array_equal(y, got[1])

    def test_parcel_labels_track_arg(self):
        # tests/test_calibration.py::test_parcel_data_pipeline's gate
        X, y, y_arg = TE.generate_parcel_training_data(
            *TARGS, n_samples=32, seed=3, t_end=10.0, dt=0.5,
            return_arg_labels=True, device=CPU)
        assert X.shape[0] == 32 and y.shape == (32,)
        assert np.all((y >= 0) & (y <= 1)) and np.isfinite(X).all()
        assert y.std() > 0.01
        assert np.corrcoef(y, y_arg)[0, 1] > 0.5


class TestParity:
    def test_mlp_forward(self, data, jax_fits):
        (X, _), _ = data
        model, params, _ = jax_fits["mlp"]
        tp = TP.mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            params),
                                     device=CPU)
        assert tp["layers.0.weight"].shape == (64, 11)
        got = TE._predict(TE.ActivationMLP(device=CPU), tp, X[:256])
        want = model.apply(params, jnp.asarray(X[:256], jnp.float32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6)

    def test_adam_from_the_flax_init(self, data, monkeypatch):
        (X, y), _ = data
        X, y = X[:256], y[:256]
        flax_model = JE.ActivationMLP(hidden=(64, 64))
        init = flax_model.init(jax.random.PRNGKey(0),
                               jnp.asarray(X[:1], jnp.float32))
        _, want, want_loss = JE.train_emulator(X, y, n_steps=20)
        start = TP.mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               init),
                                        device=CPU)

        def from_flax(hidden, n_features, seed, device):
            mlp = TE.ActivationMLP(hidden, n_features, device=device)
            mlp.load_state_dict(start)
            return mlp

        monkeypatch.setattr(TE, "_initial_mlp", from_flax)
        _, got, got_loss = TE.train_emulator(X, y, n_steps=20, device=CPU)
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
        want = TP.mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              want),
                                       device=CPU)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, err_msg=k)

    def test_gp(self, data, jax_fits):
        (X, y), (X2, _) = data
        model, params, rmse = jax_fits["gp"]
        tm, tparams, trmse = TE.train_emulator_gp(X[:256], y[:256],
                                                  device=CPU)
        assert tparams["alpha"].dtype == torch.float32
        np.testing.assert_allclose(trmse, rmse, rtol=1e-4)
        want = np.asarray(model.apply(params, X2[:64]))
        np.testing.assert_allclose(tm.apply(tparams, X2[:64]).numpy(), want,
                                   rtol=1e-4)
        conv = TP.gp_params_from_numpy(
            {k: np.asarray(v) for k, v in params.items()}, device=CPU)
        np.testing.assert_allclose(tm.apply(conv, X2[:64]).numpy(), want,
                                   rtol=1e-4)

    def test_trees(self, data, jax_fits):
        (X, y), (X2, _) = data
        model, params, rmse = jax_fits["trees"]
        tm, tparams, trmse = TE.train_emulator_trees(X[:512], y[:512],
                                                     n_trees=20, depth=4,
                                                     device=CPU)
        np.testing.assert_array_equal(tparams["features"].numpy(),
                                      np.asarray(params["features"]))
        np.testing.assert_array_equal(tparams["thresholds"].numpy(),
                                      np.asarray(params["thresholds"]))
        assert tparams["thresholds"].dtype == torch.float32
        np.testing.assert_allclose(tparams["leaves"].numpy(),
                                   np.asarray(params["leaves"]), rtol=1e-9)
        np.testing.assert_allclose(float(tparams["bias"]),
                                   float(params["bias"]), rtol=1e-9)
        conv = TP.trees_params_from_numpy(
            {k: np.asarray(v) for k, v in params.items()}, device=CPU)
        np.testing.assert_allclose(
            tm.apply(conv, X2).numpy(),
            np.asarray(model.apply(params, jnp.asarray(X2, jnp.float32))),
            rtol=1e-6, atol=ATOL_SUM)
        assert _bucket_changes(X[:512], conv) == 0

    @pytest.mark.parametrize("family", ["mlp", "gp", "trees"])
    def test_emulated_activation(self, jax_fits, family):
        model, params, _ = jax_fits[family]
        if family == "mlp":
            tmodel = TE.ActivationMLP(device=CPU)
            tparams = TP.mlp_params_from_flax(
                jax.tree_util.tree_map(np.asarray, params), device=CPU)
        elif family == "gp":
            tmodel = TE.GPRegressor(model.lengthscale, model.signal_var,
                                    model.noise, device=CPU)
            tparams = TP.gp_params_from_numpy(
                {k: np.asarray(v) for k, v in params.items()}, device=CPU)
        else:
            tmodel = TE.BoostedTreesRegressor(n_trees=20, depth=4,
                                              device=CPU)
            tparams = TP.trees_params_from_numpy(
                {k: np.asarray(v) for k, v in params.items()}, device=CPU)
        for N1, N2, r, w, T, p in STATES:
            want = JE.N_activated_per_mode_emulated(
                model, params, *JARGS[:1], _dist(JA, N1, N2, r), *JARGS[1:],
                T, p, w, 0.01, 0.0, 0.0)
            got = TE.N_activated_per_mode_emulated(
                tmodel, tparams, *TARGS[:1], _dist(TA, N1, N2, r),
                *TARGS[1:], T, p, w, 0.01, 0.0, 0.0)
            assert len(got) == 2
            for g, x in zip(got, want):
                np.testing.assert_allclose(float(g), float(x), rtol=1e-5)


class TestGates:
    """tests/test_calibration.py's gates on the port's own fits."""

    def _activation_gate(self, model, params, tol):
        ap, aip, tps = TARGS
        for N1, N2, r, w, T, p in STATES:
            ad = _dist(TA, N1, N2, r)
            em = TE.N_activated_per_mode_emulated(model, params, ap, ad, aip,
                                                  tps, T, p, w, 0.01, 0.0,
                                                  0.0)
            ex = TAA.N_activated_per_mode(
                ap, ad, aip, tps, *(torch.tensor(v, dtype=torch.float64)
                                    for v in (T, p, w, 0.01)), 0.0, 0.0)
            for e_i, x_i, N_i in zip(em, ex, (N1, N2)):
                assert 0 <= float(e_i) <= N_i
                if tol is not None:
                    assert abs(float(e_i) - float(x_i)) < tol * N_i

    def test_mlp(self, data):
        (X, y), (X2, y2) = data
        model, params, loss = TE.train_emulator(X[:512], y[:512],
                                                hidden=(64, 64),
                                                n_steps=2000, device=CPU)
        assert loss < 0.01
        pred = TE._predict(model, params, X2[:64]).detach().numpy()
        assert np.sqrt(np.mean((pred - y2[:64]) ** 2)) < 0.1
        self._activation_gate(model, params, None)

    def test_gp(self, data):
        (X, y), (X2, y2) = data
        model, params, rmse = TE.train_emulator_gp(X, y, device=CPU)
        assert rmse < 0.05
        pred = model.apply(params, X2[:64]).numpy()
        assert np.sqrt(np.mean((pred - y2[:64]) ** 2)) < 0.1
        self._activation_gate(model, params, None)

    def test_trees(self, data):
        (X, y), (X2, y2) = data
        model, params, rmse = TE.train_emulator_trees(
            X, y, n_trees=300, depth=5, learning_rate=0.12, device=CPU)
        assert rmse < 0.05
        pred = model.apply(params, X2).numpy()
        assert np.sqrt(np.mean((pred - y2) ** 2)) < 0.1
        self._activation_gate(model, params, 0.15)
        assert _bucket_changes(X, params) == 0
        # the fit is deterministic
        again = TE.train_emulator_trees(X, y, n_trees=300, depth=5,
                                        learning_rate=0.12, device=CPU)[1]
        assert all(torch.equal(params[k], again[k]) for k in params)
