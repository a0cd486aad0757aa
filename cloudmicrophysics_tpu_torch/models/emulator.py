"""ML emulator hook for ARG aerosol activation.

Port of ``cloudmicrophysics_tpu/models/emulator.py`` (reference
``ext/EmulatorModelsExt.jl``): three interchangeable regressor families
substitute for the ARG parameterization behind the same
``N_activated_per_mode`` API (an MLP, an exact-GP/kernel-ridge regressor,
and gradient-boosted oblivious trees; the reference swaps NN /
GaussianProcess / EvoTree MLJ machines the same way), with the
reference's mode-permutation trick (the model predicts the first mode's
activated fraction; other modes are predicted by swapping them into the
first slot).

Also provides the training-data pipelines of ``ext/Common.jl:30-60``
(sampling (mode parameters, w, T, p) and labeling with the ARG
parameterization or with parcel supersaturation maxima, each one batched
computation on the device) and a full-batch Adam training loop.

Every fit runs on ``device``, the GPU unless ``device="cpu"`` is asked
for. The MLP and the GP compute in float32 as in the JAX package (TF32
matrix products, which PyTorch leaves off by default, would make the
card's float32 differ from the CPU's); the trees fit in float64. The MLP's
fitted parameters are a ``{name: tensor}`` dict that
:func:`N_activated_per_mode_emulated` applies through
``torch.func.functional_call``; the GP and the trees keep the JAX
package's ``apply(params, X)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import aerosol_activation as AA
from ..parameters.aerosol import AerosolDistribution, ModeKappa
from ..utils.special import float_dtype

__all__ = ["ActivationMLP", "GPRegressor", "BoostedTreesRegressor",
           "emulator_features",
           "generate_training_data", "generate_parcel_training_data",
           "train_emulator", "train_emulator_gp", "train_emulator_trees",
           "N_activated_per_mode_emulated"]

F32, F64 = torch.float32, torch.float64

# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# scaled so that the truncated law has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class ActivationMLP(nn.Module):
    """MLP predicting the activated fraction of the first mode: ReLU
    hidden layers of widths ``hidden``, then a sigmoid output.

    Weights are initialized as flax's ``Dense`` does (LeCun normal
    kernels, zero biases) from a ``torch.Generator`` seeded ``seed`` on
    ``device``. ``nn.Linear`` keeps its weight as ``(out, in)``, the
    transpose of flax's kernel."""

    def __init__(self, hidden: Sequence[int] = (64, 64), n_features: int = 11,
                 seed: int = 0, device: torch.device | str = "cuda"):
        super().__init__()
        self.hidden = tuple(hidden)
        widths = (n_features, *self.hidden, 1)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device, dtype=F32)
            for a, b in zip(widths[:-1], widths[1:]))
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=gen)
                layer.bias.zero_()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return torch.sigmoid(self.layers[-1](x))[..., 0]


def _initial_mlp(hidden, n_features, seed, device) -> ActivationMLP:
    """The MLP :func:`train_emulator` starts from."""
    return ActivationMLP(hidden, n_features, seed=seed, device=device)


def _predict(model, params, X):
    """``model``'s prediction for ``X`` with the fitted ``params``: the MLP
    through ``torch.func.functional_call`` (``nn.Module.apply`` means
    something else), the GP and the trees through their ``apply``."""
    if isinstance(model, nn.Module):
        ref = next(iter(params.values()))
        X = torch.as_tensor(X, dtype=F32, device=ref.device)
        return torch.func.functional_call(model, params, (X,))
    return model.apply(params, X)


class GPRegressor:
    """Gaussian-process (kernel-ridge) regressor with an RBF kernel.

    Second model family behind the activation API, mirroring the
    reference's MLJ GaussianProcess machine
    (``ext/EmulatorModelsExt.jl:32-67`` swaps GP / NN / EvoTree machines
    behind the same ``N_activated_per_mode`` call). Exposes the
    ``apply(params, X)`` protocol, so :func:`N_activated_per_mode_emulated`
    works with any family. Fits on ``device``, in float32.

    The prediction is one ``K(X*, Xtrain) @ alpha`` product.
    """

    def __init__(self, lengthscale=1.0, signal_var=1.0, noise=1e-4,
                 device: torch.device | str = "cuda"):
        self.lengthscale = float(lengthscale)
        self.signal_var = float(signal_var)
        self.noise = float(noise)
        self.device = torch.device(device)

    def _k(self, A, B):
        # the difference-of-squares distance of the JAX package (not the
        # matrix-product form of torch.cdist, which rounds otherwise)
        d2 = torch.sum((A[:, None, :] - B[None, :, :]) ** 2, dim=-1)
        return self.signal_var * torch.exp(-0.5 * d2 / self.lengthscale**2)

    def fit(self, X, y):
        """Exact GP regression fit: returns the params dict
        ``{X_train, alpha, y_mean, x_mean, x_std}`` with
        ``alpha = (K + noise I)^-1 y``. Features are standardized
        internally (stored in the params) so the isotropic RBF
        lengthscale is meaningful across mixed-scale features."""
        X = torch.as_tensor(X, dtype=F32, device=self.device)
        y = torch.as_tensor(y, dtype=F32, device=self.device)
        x_mean = torch.mean(X, dim=0)
        x_std = torch.std(X, dim=0, correction=0) + 1e-8
        Xs = (X - x_mean) / x_std
        y_mean = torch.mean(y)
        K = self._k(Xs, Xs) + self.noise * torch.eye(
            X.shape[0], dtype=X.dtype, device=X.device)
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve((y - y_mean)[:, None], L)[:, 0]
        return {"X_train": Xs, "alpha": alpha, "y_mean": y_mean,
                "x_mean": x_mean, "x_std": x_std}

    def apply(self, params, X):
        X = torch.as_tensor(X, dtype=F32, device=params["alpha"].device)
        Xs = (X - params["x_mean"]) / params["x_std"]
        return self._k(Xs, params["X_train"]) @ params["alpha"] \
            + params["y_mean"]


class BoostedTreesRegressor:
    """Gradient-boosted OBLIVIOUS decision trees, the third model family
    behind the activation API (the reference swaps GP / NN / **EvoTree**
    machines behind ``N_activated_per_mode``,
    ``ext/EmulatorModelsExt.jl:32-67``).

    Oblivious (CatBoost-style) trees use ONE (feature, threshold) split
    per level, shared across the whole level, so a depth-``d`` tree is
    ``d`` comparisons and a ``2^d``-leaf lookup, and a forest's leaf
    indices are one batched bit-pack.

    The fit is the JAX package's level-wise greedy search over
    per-feature quantile candidate thresholds with exact SSE scoring, done
    for every (feature, threshold) pair at once: per level, the residual
    sums and counts of every candidate's child groups are one float64
    product of the groups' one-hot matrix with the candidates' split bits
    (a fixed summation order, so two fits on one device are equal), and
    the chosen split is the first minimum in feature-major,
    threshold-minor order, as the JAX loop's strict ``score < best``
    picks it. As there, samples are bucketed by float64 compares against
    float64 candidates, and the thresholds are stored in float32.

    Exposes the same ``apply(params, X)`` protocol as the other families.
    """

    def __init__(self, n_trees=200, depth=4, learning_rate=0.1,
                 n_thresholds=15, l2=1.0, device: torch.device | str = "cuda"):
        self.n_trees = int(n_trees)
        self.depth = int(depth)
        self.learning_rate = float(learning_rate)
        self.n_thresholds = int(n_thresholds)
        self.l2 = float(l2)
        self.device = torch.device(device)

    def fit(self, X, y):
        X = torch.as_tensor(X, dtype=F64, device=self.device)
        y = torch.as_tensor(y, dtype=F64, device=self.device)
        n, F = X.shape
        K = self.n_thresholds
        # per-feature candidate thresholds at interior quantiles
        qs = torch.as_tensor(np.linspace(0, 1, K + 2)[1:-1], dtype=F64,
                             device=self.device)
        cand = torch.quantile(X, qs, dim=0)             # (K, F)
        # every candidate's split bit, feature-major: (n, F * K)
        bits = (X[:, :, None] > cand.T[None, :, :]).reshape(n, F * K)
        bits_f = bits.to(F64)

        bias = torch.mean(y)
        resid = y - bias
        choice = torch.zeros((self.n_trees, self.depth), dtype=torch.int64,
                             device=self.device)
        leaves = torch.zeros((self.n_trees, 2 ** self.depth), dtype=F32,
                             device=self.device)
        for t in range(self.n_trees):
            group = torch.zeros(n, dtype=torch.int64, device=self.device)
            # residual sums of each candidate's two sides
            r1 = bits_f * resid[:, None]
            sides = torch.cat([resid[:, None] - r1, r1], dim=1)
            for lvl in range(self.depth):
                # each candidate's residual sums and counts in child group
                # 2 g + b (the JAX loop's bincount order), and its SSE after
                # fitting group means, up to a constant
                onehot = _one_hot(group, 2 ** lvl)
                s = (onehot.T @ sides).reshape(2 ** (lvl + 1), F * K)
                c1 = onehot.T @ bits_f
                c = torch.stack([onehot.sum(dim=0)[:, None] - c1, c1],
                                dim=1).reshape(2 ** (lvl + 1), F * K)
                score = -torch.sum(s * s / (c + self.l2), dim=0)
                best = torch.argmin(score)              # the first minimum
                choice[t, lvl] = best
                group = group * 2 + torch.index_select(
                    bits, 1, best[None])[:, 0]
            onehot = _one_hot(group, 2 ** self.depth)
            leaf = self.learning_rate * (onehot.T @ resid) / (
                onehot.sum(dim=0) + self.l2)
            leaves[t] = leaf.to(F32)
            resid = resid - leaf[group]
        feats = choice // K
        thrs = cand.T.reshape(F * K)[choice].to(F32)
        return {"features": feats, "thresholds": thrs, "leaves": leaves,
                "bias": bias.to(F32)}

    def apply(self, params, X):
        X = torch.as_tensor(X, dtype=F32, device=params["leaves"].device)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[None]
        # (B, n_trees, depth) feature gather -> bit-pack -> leaf lookup
        xf = X[:, params["features"]]                   # (B, T, D)
        bits = (xf > params["thresholds"][None]).to(torch.int64)
        pows = 2 ** torch.arange(self.depth - 1, -1, -1, device=X.device)
        idx = torch.sum(bits * pows, dim=-1)            # (B, T)
        vals = torch.gather(
            params["leaves"][None].expand(idx.shape[0], -1, -1), 2,
            idx[..., None])[..., 0]
        out = params["bias"] + torch.sum(vals, dim=-1)
        return out[0] if squeeze else out


def _one_hot(index, n):
    """Float64 one-hot rows of ``index`` over ``n`` classes."""
    return (index[:, None] == torch.arange(n, device=index.device)).to(F64)


def _rmse(pred, y) -> float:
    y = torch.as_tensor(y, dtype=F32, device=pred.device)
    return float(torch.sqrt(torch.mean((pred - y) ** 2)))


def train_emulator_trees(X, y, n_trees=200, depth=4, learning_rate=0.1,
                         device: torch.device | str = "cuda"):
    """Fit the boosted-trees family on ``device``; same result shape as
    :func:`train_emulator` / :func:`train_emulator_gp`."""
    model = BoostedTreesRegressor(n_trees=n_trees, depth=depth,
                                  learning_rate=learning_rate, device=device)
    params = model.fit(X, y)
    return model, params, _rmse(model.apply(params, X), y)


def train_emulator_gp(X, y, lengthscale=2.0, signal_var=1.0, noise=1e-2,
                      device: torch.device | str = "cuda"):
    """Fit the GP family on ``device``; returns ``(model, params,
    train_rmse)`` with the same shape of result as :func:`train_emulator`."""
    model = GPRegressor(lengthscale=lengthscale, signal_var=signal_var,
                        noise=noise, device=device)
    params = model.fit(X, y)
    return model, params, _rmse(model.apply(params, X), y)


def emulator_features(ad, ap, w, T, p):
    """Feature vector per mode-permutation: (N, r_dry, stdev, hygro) per
    mode + (w, T, p), with log-scaled magnitudes. Inputs are numbers or
    tensors of one shape; the features take their common float dtype
    (float64 for numbers) on their device."""
    hygro = AA.mean_hygroscopicity_parameter(ap, ad)
    values = [w, T, p, *hygro]
    for mode in ad.modes:
        values += [mode.N, mode.r_dry, mode.stdev]
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    dtype = float_dtype(*tensors)
    device = tensors[0].device if tensors else None

    def A(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    feats = []
    for mode, h in zip(ad.modes, hygro):
        # normalized: log-number ~[6.5, 9.5]*ln10, log-radius ~[-19, -15]
        feats += [(torch.log(A(mode.N)) - 18.0) / 4.0,
                  (torch.log(A(mode.r_dry)) + 17.0) / 2.0,
                  A(mode.stdev) - 1.9, A(h)]
    feats += [torch.log(A(w)), (A(T) - 285.0) / 15.0, (A(p) - 8.5e4) / 2e4]
    return torch.stack(torch.broadcast_tensors(*feats), dim=-1)


def _kappa_modes(r_dry, stdev, N_m, kappa):
    """One :class:`ModeKappa` per row of the ``(n_modes, n)`` tensors."""
    return tuple(
        ModeKappa(r_dry=r_dry[m], stdev=stdev[m], N=N_m[m],
                  vol_mix_ratio=(1.0,), mass_mix_ratio=(1.0,),
                  molar_mass=(0.13214,), kappa=(kappa[m],))
        for m in range(r_dry.shape[0]))


def _saturated_q_tot(tps, T, p):
    """Total water of a just-saturated state with no condensate (the ARG
    assumption)."""
    from ..ops import thermo as TDI

    p_vs = TDI.saturation_vapor_pressure_over_liquid(tps, T)
    return 1 / (1 - tps.Rv_over_Rd * (p_vs - p) / p_vs)


def generate_training_data(ap, aip, tps, n_samples=2048, n_modes=2, seed=0,
                           device: torch.device | str = "cuda"):
    """Sample (2-mode kappa aerosol, w, T, p) and label with the ARG
    parameterization (reference ext/Common.jl:30-60).

    The samples are the JAX package's draws of ``np.random.default_rng
    (seed)``. Every sample's mode parameters ride as ``(n_samples,)``
    float64 tensors on ``device`` in ONE :class:`AerosolDistribution`, so
    the whole dataset is a single batched ARG evaluation. Returns numpy
    arrays ``(X, y)``.
    """
    rng = np.random.default_rng(seed)

    def A(x):
        return torch.as_tensor(x, dtype=F64, device=device)

    r_dry = A(10 ** rng.uniform(-8.2, -6.5, (n_modes, n_samples)))
    stdev = A(rng.uniform(1.4, 2.4, (n_modes, n_samples)))
    N_m = A(10 ** rng.uniform(6.5, 9.5, (n_modes, n_samples)))
    kappa = A(rng.uniform(0.1, 1.2, (n_modes, n_samples)))
    w = A(10 ** rng.uniform(-1.5, 0.7, n_samples))
    T = A(rng.uniform(270.0, 300.0, n_samples))
    p = A(rng.uniform(7e4, 1.02e5, n_samples))

    ad = AerosolDistribution(modes=_kappa_modes(r_dry, stdev, N_m, kappa))
    q_tot = _saturated_q_tot(tps, T, p)
    n_act = AA.N_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot,
                                    0.0, 0.0)
    X = emulator_features(ad, ap, w, T, p)
    y = n_act[0] / ad.modes[0].N
    return X.cpu().numpy(), y.cpu().numpy()


def generate_parcel_training_data(ap, aip, tps, n_samples=256, n_modes=2,
                                  seed=0, t_end=20.0, dt=0.2,
                                  return_arg_labels=False,
                                  device: torch.device | str = "cuda"):
    """Parcel-ensemble training data: labels come from parcel-model
    supersaturation maxima, not from the ARG closed form.

    Mirrors the reference's parcel-driven dataset pipeline
    (``ext/Common.jl:30-60``: features are per-mode ``(N, r_dry, stdev,
    kappa)`` + ``(w, T, p)``, the label is ``mode_1_act_frac_S_interp``,
    the mode-1 activated fraction evaluated at the parcel's S_max). The
    samples run as one float32 ensemble on ``device`` (a liquid-only
    activation + condensation parcel, each member with its own parameters
    as ``(n_samples,)`` tensors); S_max is taken over the trajectory, and
    the features, the critical supersaturations, the erf labels and the
    optional ARG labels are each one float64 computation over all samples.
    Returns numpy arrays ``(X, y)`` or ``(X, y, y_arg)``.
    """
    import dataclasses

    from ..ops import thermo as TDI
    from ..parameters.aerosol_species import Sulfate
    from . import parcel as PM

    rng = np.random.default_rng(seed)

    # sampled per-ensemble-member scalars
    r_dry = 10 ** rng.uniform(-8.2, -6.8, (n_samples, n_modes))
    stdev = rng.uniform(1.4, 2.4, (n_samples, n_modes))
    N_m = 10 ** rng.uniform(6.5, 9.0, (n_samples, n_modes))
    kappa = rng.uniform(0.1, 1.2, (n_samples, n_modes))
    w = 10 ** rng.uniform(-1.0, 0.7, n_samples)
    T0 = rng.uniform(270.0, 300.0, n_samples)
    p0 = rng.uniform(7e4, 1.02e5, n_samples)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def f64(a):
        return torch.as_tensor(a, dtype=F64, device=device)

    base = PM.parcel_params(aerosol_act="AeroAct",
                            condensation_growth="Condensation",
                            aerosol=Sulfate(), aero_sigma_g=2.0,
                            const_dt=dt)
    # parcel ICs: just-saturated, no condensate (ARG assumption)
    T_i, p_i, N_tot = f32(T0), f32(p0), f32(N_m.sum(axis=1))
    z = torch.zeros_like(T_i)
    rho = TDI.air_density(tps, T_i, p_i, z, z, z)
    q_vap = TDI.p2q(tps, T_i, rho,
                    TDI.saturation_vapor_pressure_over_liquid(tps, T_i))
    S0 = float(np.float32(1.0) + np.float32(1e-4))
    ic = PM.ParcelState(S_l=torch.full_like(T_i, S0), p_air=p_i, T=T_i,
                        q_vap=q_vap, q_liq=z, q_ice=z, N_aer=N_tot, N_liq=z,
                        N_ice=z, ln_inpc=z)
    pp = dataclasses.replace(
        base, w=f32(w), r_nuc=f32(r_dry[:, 0]),
        aero_sigma_g=f32(stdev[:, 0]), N_aer_act=N_tot,
        aerosol=dataclasses.replace(base.aerosol, kappa=f32(kappa[:, 0])))
    traj = PM.run_parcel(ic, 0.0, t_end, pp)
    S_max = torch.max(traj.S_l, dim=0).values - 1.0

    ad = AerosolDistribution(modes=_kappa_modes(
        f64(r_dry.T), f64(stdev.T), f64(N_m.T), f64(kappa.T)))
    w64, T64, p64 = f64(w), f64(T0), f64(p0)
    X = emulator_features(ad, ap, w64, T64, p64)
    # mode-1 activated fraction at the parcel S_max (the reference's
    # S-interp label)
    sm1 = AA.critical_supersaturation(ap, ad, T64)[0]
    smax = torch.clamp(S_max.to(F64), min=1e-10)
    u = 2 * torch.log(sm1 / smax) / 3 / math.sqrt(2.0) \
        / torch.log(ad.modes[0].stdev)
    y = 0.5 * (1 - torch.special.erf(u))
    out = [X.cpu().numpy(), y.cpu().numpy()]
    if return_arg_labels:
        # ARG closed-form label for the SAME configuration (used to
        # validate the parcel labels against the parameterization)
        q_tot = _saturated_q_tot(tps, T64, p64)
        n_act = AA.N_activated_per_mode(ap, ad, aip, tps, T64, p64, w64,
                                        q_tot, 0.0, 0.0)
        out.append((n_act[0] / ad.modes[0].N).cpu().numpy())
    return tuple(out)


def train_emulator(X, y, hidden=(64, 64), n_steps=2000, lr=1e-3, seed=0,
                   device: torch.device | str = "cuda"):
    """Train the MLP with full-batch Adam (``torch.optim.Adam``, betas
    (0.9, 0.999), eps 1e-8: optax's ``adam``) in float32 on ``device``;
    returns ``(model, params, loss)``, the loss of the last step's
    parameters before its update as in the JAX package."""
    X = torch.as_tensor(X, dtype=F32, device=device)
    y = torch.as_tensor(y, dtype=F32, device=device)
    model = _initial_mlp(hidden, X.shape[-1], seed, device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = None
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(X) - y) ** 2)
        loss.backward()
        opt.step()
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    return model, params, float(loss.detach())


def N_activated_per_mode_emulated(model, params, ap, ad, aip, tps,
                                  T, p, w, q_tot, q_liq, q_ice):
    """Emulated activated number per mode (reference
    ext/EmulatorModelsExt.jl:32-67): predict mode 1's activated fraction,
    permuting each mode into the first slot. Runs where ``params`` live."""
    n_modes = len(ad.modes)
    device = next(iter(params.values())).device
    T, p, w = (torch.as_tensor(v, dtype=float_dtype(v), device=device)
               for v in (T, p, w))
    out = []
    for i in range(n_modes):
        perm = list(range(n_modes))
        perm[0], perm[i] = perm[i], perm[0]
        ad_p = AerosolDistribution(modes=tuple(ad.modes[j] for j in perm))
        x = emulator_features(ad_p, ap, w, T, p)
        frac = torch.clamp(_predict(model, params, x[None])[0], 0.0, 1.0)
        out.append(frac * ad.modes[i].N)
    return tuple(out)
