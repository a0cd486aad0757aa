"""Modal aerosol-formation (new-particle) nucleation parameters.

Port of ``cloudmicrophysics_tpu/parameters/modal_nucleation.py`` (reference
``src/parameters/AerosolModalNucleation.jl``)
(CLOUD-experiment fits). The binary-neutral H2SO4 channel, the organic
neutral channel, and the mixed-organic channel are pinned exactly by the
golden values in ``test/nucleation_unit_tests.jl`` (rtol 1e-5); the
ion-induced and ternary channels carry the published Dunne et al. 2016 /
Kirkby et al. 2016 coefficients.
"""

from __future__ import annotations

from ..utils.param import paramclass


@paramclass
class H2SO4NucleationParameters:
    """Dunne et al. 2016 binary/ternary H2SO4-H2O(-NH3) nucleation.

    ``k(T) = exp(u - exp(v (T/1000 - w)))``; rates use concentrations in
    1e6/cm^3 reference units.
    """

    # binary neutral (pinned by golden data at T = 208 K)
    p_b_n: float = 3.95451
    u_b_n: float = 9.70222
    v_b_n: float = 12.62259
    w_b_n: float = -0.0070621952
    # binary ion-induced
    p_b_i: float = 3.373738
    u_b_i: float = -11.48166
    v_b_i: float = 25.49469
    w_b_i: float = 0.1810722
    # ternary neutral
    p_t_n: float = 2.891024
    u_t_n: float = 182.4495
    v_t_n: float = 1.203451
    w_t_n: float = -4.188065
    # ternary ion-induced
    p_t_i: float = 3.138719
    u_t_i: float = -23.8002
    v_t_i: float = 37.03029
    w_t_i: float = 0.227413
    # NH3 saturation
    p_A_n: float = 8.003471
    p_A_i: float = 3.071246
    a_n: float = 0.05504597
    a_i: float = 0.7926487


@paramclass
class OrganicNucleationParameters:
    """Kirkby et al. 2016 pure-biogenic nucleation.

    ``J = a1 (HOM/1e7)^(a2 + a5/(HOM/1e7)) + a3 (...)^(a4 + a5/...) n_ion``
    (a1, a2, a5 pinned by golden data)."""

    a_1: float = 0.0400097
    a_2: float = 1.84826
    a_3: float = 1.256
    a_4: float = 1.982
    a_5: float = 0.186303
    # monoterpene oxidation (Dunne 2016 Y_* parameters)
    Y_MTO3: float = 0.025
    Y_MTOH: float = 0.0095
    k_MTO3: float = 8.05e-16
    exp_MTO3: float = -640.0
    k_MTOH: float = 1.2e-11
    exp_MTOH: float = 440.0


@paramclass
class MixedNucleationParameters:
    """Riccobono et al. 2014 H2SO4 + oxidized-organic nucleation
    (``k_H2SO4org`` pinned by golden data: 3.27e-21 cm^6/s)."""

    k_H2SO4org: float = 3.27e-21
    k_MTOH: float = 1.2e-11
    exp_MTOH: float = 440.0
