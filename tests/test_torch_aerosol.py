"""The port's aerosol parameters, ARG2000 activation and new-particle
formation rates against the JAX package at float64.

The three parameter modules (``parameters/aerosol.py``,
``aerosol_species.py``, ``modal_nucleation.py``) are walked field by field;
``from_tree`` rebuilds each struct from the JAX one. The activation and
nucleation functions take the same seeded NumPy inputs in both packages
and agree to rtol 1e-9 (an absolute floor of 1e-300 for values that
underflow alike).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.ops import aerosol_activation as JAA
from cloudmicrophysics_tpu.ops import nucleation as JNU
from cloudmicrophysics_tpu.parameters import aerosol as JPA
from cloudmicrophysics_tpu.parameters import aerosol_species as JSP
from cloudmicrophysics_tpu.parameters import modal_nucleation as JMN
from cloudmicrophysics_tpu_torch.ops import aerosol_activation as TAA
from cloudmicrophysics_tpu_torch.ops import nucleation as TNU
from cloudmicrophysics_tpu_torch.parameters import aerosol as TPA
from cloudmicrophysics_tpu_torch.parameters import aerosol_species as TSP
from cloudmicrophysics_tpu_torch.parameters import modal_nucleation as TMN

RTOL = 1e-9
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
AIP_J, AIP_T = JP.AirProperties(), TP.AirProperties()


def _close(got, want, what):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300,
                               err_msg=what)


def _classes(module):
    return sorted(name for name, c in vars(module).items()
                  if isinstance(c, type) and dataclasses.is_dataclass(c)
                  and c.__module__ == module.__name__)


PARAM_CLASSES = [(m, name) for m, mod in (("aerosol", JPA),
                                          ("aerosol_species", JSP),
                                          ("modal_nucleation", JMN))
                 for name in _classes(mod)]
PORT = {"aerosol": TPA, "aerosol_species": TSP, "modal_nucleation": TMN}
JAX = {"aerosol": JPA, "aerosol_species": JSP, "modal_nucleation": JMN}


@pytest.mark.parametrize("module,name", PARAM_CLASSES)
def test_parameter_class_fields_and_defaults(module, name):
    j, t = getattr(JAX[module], name), getattr(PORT[module], name)
    fj, ft = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in ft] == [f.name for f in fj]
    assert [f.default for f in ft] == [f.default for f in fj]


def test_modal_nucleation_exported_from_the_package():
    for name in ("H2SO4NucleationParameters", "OrganicNucleationParameters",
                 "MixedNucleationParameters"):
        assert getattr(TP, name) is getattr(TMN, name)


# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------

def _modes(pa, sp):
    ss, su = sp.Seasalt(), sp.Sulfate()
    accum_b = pa.ModeB(r_dry=0.243e-6, stdev=1.4, N=100e6,
                       mass_mix_ratio=(0.7, 0.3),
                       soluble_mass_frac=(ss.epsilon, su.epsilon),
                       osmotic_coeff=(ss.phi, su.phi),
                       molar_mass=(ss.M, su.M), dissoc=(ss.nu, su.nu),
                       aerosol_density=(ss.rho, su.rho))
    coarse_k = pa.ModeKappa(r_dry=1.5e-6, stdev=2.1, N=1e6,
                            vol_mix_ratio=(0.4, 0.6),
                            mass_mix_ratio=(0.5, 0.5),
                            molar_mass=(ss.M, su.M),
                            kappa=(ss.kappa, su.kappa))
    paper_k = pa.ModeKappa(r_dry=0.05e-6, stdev=2.0, N=100e6,
                           vol_mix_ratio=(1.0,), mass_mix_ratio=(1.0,),
                           molar_mass=(su.M,), kappa=(su.kappa,))
    return pa.AerosolDistribution(modes=(accum_b, coarse_k, paper_k))


AD_J, AD_T = _modes(JPA, JSP), _modes(TPA, TSP)
AP_J, AP_T = JPA.AerosolActivationParameters(), TPA.AerosolActivationParameters()


def test_from_tree_rebuilds_the_distribution_and_species():
    assert TP.from_tree(TPA.AerosolDistribution,
                        dataclasses.asdict(AD_J)) == AD_T
    assert TP.from_tree(TPA.AerosolActivationParameters,
                        dataclasses.asdict(AP_J)) == AP_T
    for name in _classes(JSP):
        cls = getattr(TSP, name)
        assert TP.from_tree(cls, dataclasses.asdict(getattr(JSP, name)())) \
            == cls()


def _air(n=64, seed=11):
    rng = np.random.default_rng(seed)
    T = rng.uniform(265.0, 300.0, n)
    p = rng.uniform(6e4, 1.02e5, n)
    # near saturation over liquid: q_vap from p_vs, as the JAX tests build it
    p_vs = np.asarray(JAA.TDI.saturation_vapor_pressure_over_liquid(
        TPS_J, jnp.asarray(T)))
    q_sat = 1 / (1 - TPS_J.Rv_over_Rd * (p_vs - p) / p_vs)
    q_liq = np.where(rng.random(n) < 0.5, rng.uniform(0, 1e-3, n), 0.0)
    q_ice = np.where(rng.random(n) < 0.3, rng.uniform(0, 1e-4, n), 0.0)
    return dict(T=T, p=p, w=10 ** rng.uniform(-2, 1, n),
                q_tot=q_sat * rng.uniform(0.99, 1.01, n) + q_liq + q_ice,
                q_liq=q_liq, q_ice=q_ice,
                N_liq=np.where(q_liq > 0, rng.uniform(1e7, 3e8, n), 0.0),
                N_ice=np.where(q_ice > 0, rng.uniform(1e3, 1e6, n), 0.0))


AIR = _air()
ACTIVATION = ("max_supersaturation", "N_activated_per_mode",
              "M_activated_per_mode", "total_N_activated",
              "total_M_activated")


def _activation(AA, ap, ad, aip, tps, wrap, name, sinks):
    x = {k: wrap(v) for k, v in AIR.items()}
    args = [x[k] for k in ("T", "p", "w", "q_tot", "q_liq", "q_ice")]
    extra = (x["N_liq"], x["N_ice"]) if sinks else ()
    return getattr(AA, name)(ap, ad, aip, tps, *args, *extra)


@pytest.mark.parametrize("sinks", [False, True])
@pytest.mark.parametrize("name", ACTIVATION)
def test_activation_matches_jax(name, sinks):
    got = _activation(TAA, AP_T, AD_T, AIP_T, TPS_T, torch.tensor, name,
                      sinks)
    want = _activation(JAA, AP_J, AD_J, AIP_J, TPS_J, jnp.asarray, name,
                       sinks)
    if isinstance(want, tuple):
        assert len(got) == len(want) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name}[{i}]")
    else:
        _close(got, want, name)


def test_curvature_hygroscopicity_and_critical_supersaturation():
    T = AIR["T"]
    _close(TAA.coeff_of_curvature(AP_T, torch.tensor(T)),
           JAA.coeff_of_curvature(AP_J, jnp.asarray(T)), "A")
    for i, (g, w) in enumerate(zip(
            TAA.mean_hygroscopicity_parameter(AP_T, AD_T),
            JAA.mean_hygroscopicity_parameter(AP_J, AD_J))):
        _close(g, w, f"hygroscopicity[{i}]")
    for i, (g, w) in enumerate(zip(
            TAA.critical_supersaturation(AP_T, AD_T, torch.tensor(T)),
            JAA.critical_supersaturation(AP_J, AD_J, jnp.asarray(T)))):
        _close(g, w, f"critical_supersaturation[{i}]")


def test_activation_takes_per_member_mode_parameters():
    """A mode's numeric fields as tensors of one value per member (the
    port's counterpart of a vmap over modes) give each member its own
    float-parameter activation."""
    x = {k: torch.tensor(v[:4]) for k, v in AIR.items()}
    args = [x[k] for k in ("T", "p", "w", "q_tot", "q_liq", "q_ice")]
    r = torch.tensor([3e-8, 5e-8, 1e-7, 2e-7], dtype=torch.float64)
    kappa = torch.tensor([0.2, 0.5, 0.9, 1.1], dtype=torch.float64)
    base = AD_T.modes[2]
    ad = TPA.AerosolDistribution(modes=(dataclasses.replace(
        base, r_dry=r, kappa=(kappa,)),))
    got = TAA.total_N_activated(AP_T, ad, AIP_T, TPS_T, *args)
    for i in range(4):
        one = TPA.AerosolDistribution(modes=(dataclasses.replace(
            base, r_dry=float(r[i]), kappa=(float(kappa[i]),)),))
        want = TAA.total_N_activated(AP_T, one, AIP_T, TPS_T,
                                     *(a[i:i + 1] for a in args))
        np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                   rtol=1e-12)


def _per_point_modes(pa, sp, wrap, shape=(8, 8), seed=31):
    """Two kappa modes whose N, r_dry and species fractions are fields of
    the state's ``(ncol, nlev)`` shape (a host model's grid), stdev and the
    species' constants scalars."""
    rng = np.random.default_rng(seed)
    ss, su = sp.Seasalt(), sp.Sulfate()
    modes = []
    for r_lo, r_hi, n_lo, n_hi, stdev in ((2e-8, 2e-7, 1e7, 1e9, 1.8),
                                          (5e-7, 2e-6, 1e5, 1e7, 1.8)):
        vol = rng.uniform(0.05, 1.0, shape)
        mass = rng.uniform(0.05, 1.0, shape)
        modes.append(pa.ModeKappa(
            r_dry=wrap(np.exp(rng.uniform(np.log(r_lo), np.log(r_hi),
                                          shape))),
            stdev=stdev,
            N=wrap(np.exp(rng.uniform(np.log(n_lo), np.log(n_hi), shape))),
            vol_mix_ratio=(wrap(vol / (vol + 1)), wrap(1 / (vol + 1))),
            mass_mix_ratio=(wrap(mass / (mass + 1)), wrap(1 / (mass + 1))),
            molar_mass=(ss.M, su.M), kappa=(ss.kappa, su.kappa)))
    return pa.AerosolDistribution(modes=tuple(modes))


@pytest.mark.parametrize("name", ACTIVATION)
def test_activation_takes_per_point_mode_fields(name):
    """A mode's fields as tensors of the state's ``(ncol, nlev)`` shape, as
    a host model's grid holds them, agree with the JAX package at float64,
    and the port's answers keep the state's shape."""

    def run(AA, pa, sp, ap, aip, tps, wrap):
        x = {k: wrap(v.reshape(8, 8)) for k, v in AIR.items()}
        args = [x[k] for k in ("T", "p", "w", "q_tot", "q_liq", "q_ice",
                               "N_liq", "N_ice")]
        return getattr(AA, name)(ap, _per_point_modes(pa, sp, wrap), aip,
                                 tps, *args)

    got = run(TAA, TPA, TSP, AP_T, AIP_T, TPS_T, torch.tensor)
    want = run(JAA, JPA, JSP, AP_J, AIP_J, TPS_J, jnp.asarray)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (8, 8)
        _close(g, w, f"{name}[{i}]")


# ---------------------------------------------------------------------------
# new-particle formation
# ---------------------------------------------------------------------------

def _npf(NU, mn, wrap):
    rng = np.random.default_rng(21)
    n = 40
    x = {k: wrap(v) for k, v in dict(
        h2so4=10 ** rng.uniform(11, 15, n), nh3=np.where(
            rng.random(n) < 0.3, 0.0, 10 ** rng.uniform(12, 16, n)),
        ion=10 ** rng.uniform(6, 9, n), T=rng.uniform(200.0, 300.0, n),
        hom=10 ** rng.uniform(6, 8.5, n), mt=10 ** rng.uniform(14, 16, n),
        o3=10 ** rng.uniform(17, 18.5, n), oh=10 ** rng.uniform(11, 13, n),
        cs=10 ** rng.uniform(-3.5, -2, n), d_out=rng.uniform(3.0, 20.0, n),
        J=10 ** rng.uniform(0, 3, n), gr=rng.uniform(0.5, 5.0, n),
        cs_in=10 ** rng.uniform(-4, -3, n)).items()}
    h2so4, org, mix = (mn.H2SO4NucleationParameters(),
                       mn.OrganicNucleationParameters(),
                       mn.MixedNucleationParameters())
    b, t = NU.h2so4_nucleation_rate(x["h2so4"], x["nh3"], x["ion"], x["T"],
                                    h2so4)
    return {
        "h2so4.binary": b, "h2so4.ternary": t,
        "organic_hom_prescribed": NU.organic_nucleation_rate_hom_prescribed(
            x["ion"], x["hom"], org),
        "organic": NU.organic_nucleation_rate(
            x["ion"], x["mt"], x["o3"], x["oh"], x["T"], x["cs"], org),
        "mixed_prescribed":
            NU.organic_and_h2so4_nucleation_rate_bioOxOrg_prescribed(
                x["h2so4"], x["hom"], mix),
        "mixed": NU.organic_and_h2so4_nucleation_rate(
            x["h2so4"], x["mt"], x["oh"], x["T"], x["cs"], mix),
        "apparent": NU.apparent_nucleation_rate(
            x["d_out"], x["J"], x["gr"], x["cs"] * 0.1, x["cs_in"]),
    }


NPF_KEYS = sorted(_npf(TNU, TMN, torch.tensor))


@pytest.fixture(scope="module")
def npf():
    return _npf(TNU, TMN, torch.tensor), _npf(JNU, JMN, jnp.asarray)


@pytest.mark.parametrize("key", NPF_KEYS)
def test_nucleation_rate_matches_jax(npf, key):
    got, want = npf
    _close(got[key], want[key], key)


# ---------------------------------------------------------------------------
# the ported modules' surface
# ---------------------------------------------------------------------------

SLICE_MODULES = ["parameters.aerosol", "parameters.aerosol_species",
                 "parameters.modal_nucleation", "ops.aerosol_activation",
                 "ops.ice_nucleation", "ops.nucleation", "ops.diagnostics",
                 "ops.susceptibility", "ops.p3_processes", "ops.p3",
                 "models.parcel", "models.box", "models.p3_sandbox"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_module_has_the_jax_names_and_signatures(module):
    """Every function and class the JAX module defines is in the port's,
    each public function with the same parameter names and defaults (a
    private helper may drop a TPU-only argument, as ``_brent_fixed``'s
    ``unroll``)."""
    import importlib
    import inspect

    jm = importlib.import_module(f"cloudmicrophysics_tpu.{module}")
    tm = importlib.import_module(f"cloudmicrophysics_tpu_torch.{module}")
    names = [n for n, v in vars(jm).items()
             if (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == jm.__name__]
    assert names
    for name in names:
        assert hasattr(tm, name), name
        jv, tv = getattr(jm, name), getattr(tm, name)
        if inspect.isfunction(jv) and not name.startswith("_"):
            jp = inspect.signature(jv).parameters.values()
            tp = inspect.signature(tv).parameters.values()
            assert [(p.name, p.default) for p in tp] \
                == [(p.name, p.default) for p in jp], name
    assert set(getattr(jm, "__all__", ())) <= set(getattr(tm, "__all__", ()))
