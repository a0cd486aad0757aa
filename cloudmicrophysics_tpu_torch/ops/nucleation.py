"""New-particle-formation (aerosol nucleation) rates.

Port of ``cloudmicrophysics_tpu/ops/nucleation.py`` (reference
``src/Nucleation.jl``): Lehtinen 2007 apparent nucleation rate, Dunne 2016
binary/ternary H2SO4 CLOUD fits, Kirkby 2016 pure-organic nucleation, and
Riccobono 2014 mixed organic-H2SO4 nucleation. All rates in SI
(1/m^3/s) with the reference's cm^3-based internal fit conventions.
"""

from __future__ import annotations

import torch

from ..parameters.modal_nucleation import (
    H2SO4NucleationParameters,
    MixedNucleationParameters,
    OrganicNucleationParameters,
)
from ..utils.special import float_dtype, floatmin

__all__ = [
    "apparent_nucleation_rate",
    "h2so4_nucleation_rate",
    "organic_nucleation_rate",
    "organic_nucleation_rate_hom_prescribed",
    "organic_and_h2so4_nucleation_rate",
    "organic_and_h2so4_nucleation_rate_bioOxOrg_prescribed",
]


def apparent_nucleation_rate(output_diam, nucleation_rate,
                             condensation_growth_rate, coag_sink,
                             coag_sink_input_diam, input_diam=1.7):
    """Lehtinen et al. 2007 apparent nucleation rate at ``output_diam``
    (reference src/Nucleation.jl:23-37)."""
    m = torch.log(coag_sink / coag_sink_input_diam) \
        / torch.log(output_diam / input_diam)
    gamma = 1 / (m + 1) * ((output_diam / input_diam) ** (m + 1) - 1)
    return nucleation_rate * torch.exp(
        -gamma * input_diam * coag_sink_input_diam / condensation_growth_rate)


def _k(T, u, v, w):
    return torch.exp(u - torch.exp(v * (T / 1000 - w)))


def h2so4_nucleation_rate(h2so4_conc, nh3_conc, negative_ion_conc, T,
                          params: H2SO4NucleationParameters):
    """Binary + ternary H2SO4 nucleation (Dunne et al. 2016 App. 8-10).

    Inputs in 1/m^3; returns ``(binary_rate, ternary_rate)`` in 1/m^3/s
    (reference src/Nucleation.jl:51-90)."""
    c = h2so4_conc * 1e-6      # 1/cm^3
    nh3 = nh3_conc * 1e-6
    ref = 1e6

    def f_y(p_t, p_A, a):
        nh3_r = nh3 / ref
        c_r = c / ref
        nh3_safe = torch.clamp(nh3_r, min=floatmin(float_dtype(nh3_r)))
        return nh3_r / (a + c_r**p_t / nh3_safe**p_A)

    k_b_n = _k(T, params.u_b_n, params.v_b_n, params.w_b_n)
    k_b_i = _k(T, params.u_b_i, params.v_b_i, params.w_b_i)
    k_t_n = _k(T, params.u_t_n, params.v_t_n, params.w_t_n)
    k_t_i = _k(T, params.u_t_i, params.v_t_i, params.w_t_i)
    f_n = f_y(params.p_t_n, params.p_A_n, params.a_n)
    f_i = f_y(params.p_t_i, params.p_A_i, params.a_i)

    binary = (k_b_n * (c / ref) ** params.p_b_n
              + k_b_i * (c / ref) ** params.p_b_i * negative_ion_conc)
    ternary = (k_t_n * f_n * (c / ref) ** params.p_t_n
               + k_t_i * f_i * (c / ref) ** params.p_t_i * negative_ion_conc)
    return binary * 1e6, ternary * 1e6


def organic_nucleation_rate_hom_prescribed(
    negative_ion_conc, HOM_conc, params: OrganicNucleationParameters,
):
    """Kirkby et al. 2016 biogenic nucleation with prescribed HOM [1/cm^3]
    (reference src/Nucleation.jl:135-157)."""
    ref = 1e7
    r = HOM_conc / ref
    rate = (params.a_1 * r ** (params.a_2 + params.a_5 / r)
            + params.a_3 * r ** (params.a_4 + params.a_5 / r)
            * negative_ion_conc)
    return rate * 1e6


def organic_nucleation_rate(negative_ion_conc, monoterpene_conc, O3_conc,
                            OH_conc, T, condensation_sink,
                            params: OrganicNucleationParameters):
    """Kirkby 2016 with HOM from monoterpene oxidation
    (reference src/Nucleation.jl:106-134)."""
    ion = negative_ion_conc * 1e-6
    mt = monoterpene_conc * 1e-6
    o3 = O3_conc * 1e-6
    oh = OH_conc * 1e-6
    k_MTO3 = params.k_MTO3 * torch.exp(params.exp_MTO3 / T)
    k_MTOH = params.k_MTOH * torch.exp(params.exp_MTOH / T)
    HOM = (params.Y_MTO3 * k_MTO3 * mt * o3
           + params.Y_MTOH * k_MTOH * mt * oh) / condensation_sink
    return organic_nucleation_rate_hom_prescribed(ion, HOM, params)


def organic_and_h2so4_nucleation_rate_bioOxOrg_prescribed(
    h2so4_conc, bioOxOrg, params: MixedNucleationParameters,
):
    """Riccobono et al. 2014 mixed nucleation with prescribed bioOxOrg
    (reference src/Nucleation.jl:187-202)."""
    k = 1e-6 * params.k_H2SO4org
    rate = 0.5 * k * h2so4_conc**2 * (bioOxOrg * 1e-6)
    return rate * 1e6


def organic_and_h2so4_nucleation_rate(h2so4_conc, monoterpene_conc, OH_conc,
                                      T, condensation_sink,
                                      params: MixedNucleationParameters):
    """Riccobono 2014 with bioOxOrg from monoterpene + OH
    (reference src/Nucleation.jl:168-186)."""
    k_MTOH = params.k_MTOH * torch.exp(params.exp_MTOH / T)
    bioOxOrg = k_MTOH * monoterpene_conc * OH_conc / condensation_sink * 1e6
    return organic_and_h2so4_nucleation_rate_bioOxOrg_prescribed(
        h2so4_conc, bioOxOrg, params)
