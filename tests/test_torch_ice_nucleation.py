"""The port's Mohler 2006, ABDINM/ABIFM, P3 ``N_i``, Koop 2000 rates and
``het_ice_nucleation`` against the JAX package at float64, rtol 1e-9, on
seeded NumPy inputs that straddle each rate's switches (the Mohler
threshold temperature, freezing, the Koop clamp window).

``P3_het_N_i`` is ``N_l (1 - exp(-x))`` with ``x`` down to ~1e-12 at the
droplet volumes a parcel holds: one ULP of ``exp`` (XLA's and PyTorch's
differ by that much) is an absolute error of ~1e-16 in ``1 - exp(-x)``,
so both packages carry an error of a few ``N_l`` ULP. Its comparison adds
that floor, ``8 eps N_l`` per element, to rtol 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.ops import ice_nucleation as JIN
from cloudmicrophysics_tpu.ops import p3_processes as JPP
from cloudmicrophysics_tpu.parameters import aerosol_species as JSP
from cloudmicrophysics_tpu_torch.ops import ice_nucleation as TIN
from cloudmicrophysics_tpu_torch.ops import p3_processes as TPP
from cloudmicrophysics_tpu_torch.parameters import aerosol_species as TSP

RTOL = 1e-9
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
IP_J, IP_T = (JP.ice_nucleation.ice_nucleation_parameters(),
              TP.ice_nucleation_parameters())


def _inputs(n=60, seed=4):
    rng = np.random.default_rng(seed)
    T = rng.uniform(200.0, 280.0, n)
    T[:3] = [220.0, 233.0, 273.15]    # the switches themselves
    return dict(T=T, Si=rng.uniform(0.9, 1.5, n),
                dSi=rng.uniform(-1e-3, 1e-3, n),
                N_aer=10 ** rng.uniform(3, 8, n),
                da=np.concatenate([[0.26, 0.34], rng.uniform(0.1, 0.45,
                                                              n - 2)]),
                N_l=10 ** rng.uniform(5, 9, n), V_l=10 ** rng.uniform(-18, -14,
                                                                     n),
                q_l=rng.uniform(0, 1e-3, n), RH=rng.uniform(0.8, 1.05, n),
                rho=rng.uniform(0.4, 1.3, n))


def _rates(IN, PP, sp, ip, tps, wrap):
    x = {k: wrap(v) for k, v in _inputs().items()}
    out = {}
    for dust in ("DesertDust", "ArizonaTestDust"):
        d = getattr(sp, dust)()
        out[f"dust_activated_number_fraction[{dust}]"] = \
            IN.dust_activated_number_fraction(d, ip.deposition, x["Si"],
                                              x["T"])
        out[f"mohler_deposition_rate[{dust}]"] = IN.mohler_deposition_rate(
            d, ip.deposition, x["Si"], x["T"], x["dSi"], x["N_aer"])
    for dust in ("Illite", "Kaolinite", "Feldspar", "DesertDust"):
        d = getattr(sp, dust)()
        out[f"deposition_J[{dust}]"] = IN.deposition_J(d, x["da"])
        out[f"ABIFM_J[{dust}]"] = IN.ABIFM_J(d, x["da"])
    out["P3_deposition_N_i"] = IN.P3_deposition_N_i(ip.p3, x["T"])
    out["P3_het_N_i"] = IN.P3_het_N_i(ip.p3, x["T"], x["N_l"], x["V_l"], 0.5)
    out["homogeneous_J_cubic"] = IN.homogeneous_J_cubic(ip.homogeneous,
                                                        x["da"])
    out["homogeneous_J_linear"] = IN.homogeneous_J_linear(ip.homogeneous,
                                                          x["da"])
    for dust in ("Illite", "Kaolinite"):
        dN, dL = PP.het_ice_nucleation(getattr(sp, dust)(), tps, x["q_l"],
                                       x["N_l"], x["RH"], x["T"], x["rho"])
        out[f"het_ice_nucleation.dNdt[{dust}]"] = dN
        out[f"het_ice_nucleation.dLdt[{dust}]"] = dL
    return out


KEYS = sorted(_rates(TIN, TPP, TSP, IP_T, TPS_T, torch.tensor))


@pytest.fixture(scope="module")
def rates():
    return (_rates(TIN, TPP, TSP, IP_T, TPS_T, torch.tensor),
            _rates(JIN, JPP, JSP, IP_J, TPS_J, jnp.asarray))


@pytest.mark.parametrize("key", KEYS)
def test_rate_matches_jax(rates, key):
    got, want = rates
    g, w = got[key].numpy(), np.asarray(want[key])
    assert g.shape == w.shape
    floor = np.full_like(w, 1e-300)
    if key == "P3_het_N_i":
        floor = 8 * np.finfo(np.float64).eps * _inputs()["N_l"]
    assert np.all(np.abs(g - w) <= RTOL * np.abs(w) + floor), key


def test_dust_rates_take_per_member_coefficients():
    """ABIFM coefficients as tensors of one value per member (the port's
    counterpart of the calibration's vmap over ``m, c``) give each member
    its own rate."""
    m = torch.tensor([20.0, 37.3, 54.48], dtype=torch.float64)
    c = torch.tensor([-1.0, -5.54, -10.67], dtype=torch.float64)
    da = torch.tensor([0.2, 0.25, 0.3], dtype=torch.float64)
    dust = TSP.Illite()
    got = TIN.ABIFM_J(dataclasses.replace(dust, ABIFM_m=m, ABIFM_c=c), da)
    for i in range(3):
        want = TIN.ABIFM_J(dataclasses.replace(
            dust, ABIFM_m=float(m[i]), ABIFM_c=float(c[i])), da[i:i + 1])
        np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                   rtol=1e-12)
