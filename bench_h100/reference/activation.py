"""A host model's droplet-activation step, frozen for the benchmark.

What ``ndrop`` does with ARG2000 on every grid point of a step (Ghan et
al. 2011): the activated number and mass of each mode
(``ops/aerosol_activation.py``'s ``N_activated_per_mode`` and
``M_activated_per_mode``, frozen copies of the program's), then the
droplet source in the form of Morrison and Gettelman (2008),
``max(0, N_act - N_liq) / dt``, which over one step is
``N_liq <- max(N_liq, sum of N_act)`` where the point is cloudy
(:func:`host_update`).

The state is flat, one ``(ncol, nlev)`` tensor a field (:class:`Layout`):
the air (``T``, ``p``, ``w``, ``q_tot``, ``q_liq``, ``q_ice``, ``N_liq``,
``N_ice``), each mode's ``N``, ``r_dry`` and its species' volume and mass
fractions, and the last step's activated numbers and masses. Plain
``torch``: it imports nothing of the program, and computes in the floating
dtype its inputs carry.
"""

from __future__ import annotations

import collections
import functools
import operator

import torch

from .ops import aerosol_activation as AA
from .parameters.aerosol import (
    AerosolActivationParameters,
    AerosolDistribution,
    ModeKappa,
)
from .parameters.common import AirProperties
from .parameters.thermodynamics import ThermodynamicsParameters

__all__ = ["Layout", "activation_step", "host_update", "params", "step"]

AIR = ("T", "p", "w", "q_tot", "q_liq", "q_ice", "N_liq", "N_ice")


class Layout:
    """The flat state of a configuration's mode table (``config["modes"]``,
    ``config["species"]``): ``inputs`` (the air, then each mode's ``N_<m>``,
    ``r_dry_<m>``, ``vol_<m>_<s>`` and ``mass_<m>_<s>``), ``outputs``
    (``N_act_<m>``, then ``M_act_<m>``), ``answers`` (the outputs and
    ``N_liq``) and ``State``, a named tuple of them all."""

    def __init__(self, config: dict):
        self.modes = config["modes"]
        self.species = config["species"]
        names = list(AIR)
        for m in self.modes:
            n = m["name"]
            names += [f"N_{n}", f"r_dry_{n}"]
            names += [f"vol_{n}_{s}" for s in m["species"]]
            names += [f"mass_{n}_{s}" for s in m["species"]]
        self.inputs = tuple(names)
        self.outputs = (tuple(f"N_act_{m['name']}" for m in self.modes)
                        + tuple(f"M_act_{m['name']}" for m in self.modes))
        self.answers = self.outputs + ("N_liq",)
        self.State = collections.namedtuple("ActivationState",
                                            self.inputs + self.outputs)

    def distribution(self, state, mode_cls=ModeKappa,
                     dist_cls=AerosolDistribution):
        """The state's aerosol as ``dist_cls`` of ``mode_cls`` modes (the
        frozen classes, or the program's), per-point fields as tensors."""
        modes = []
        for m in self.modes:
            n, sp = m["name"], m["species"]
            modes.append(mode_cls(
                r_dry=getattr(state, f"r_dry_{n}"), stdev=m["stdev"],
                N=getattr(state, f"N_{n}"),
                vol_mix_ratio=tuple(getattr(state, f"vol_{n}_{s}")
                                    for s in sp),
                mass_mix_ratio=tuple(getattr(state, f"mass_{n}_{s}")
                                     for s in sp),
                molar_mass=tuple(self.species[s]["molar_mass"] for s in sp),
                kappa=tuple(self.species[s]["kappa"] for s in sp)))
        return dist_cls(modes=tuple(modes))

    def air(self, state) -> tuple:
        """``(T, p, w, q_tot, q_liq, q_ice, N_liq, N_ice)``: the activation
        functions' arguments after the parameters."""
        return tuple(getattr(state, f) for f in AIR)

    def with_outputs(self, state, n_act, m_act, N_liq):
        """``state`` with the step's activated numbers and masses and the
        updated ``N_liq``."""
        new = dict(zip(self.outputs, tuple(n_act) + tuple(m_act)))
        return state._replace(N_liq=N_liq, **new)


def params():
    """``(ap, aip, tps)``: the default ARG2000 constants, air properties and
    thermodynamics parameters."""
    return (AerosolActivationParameters(), AirProperties(),
            ThermodynamicsParameters())


def host_update(q_liq, N_liq, n_act):
    """``N_liq <- max(N_liq, sum of n_act)`` where ``q_liq > 0``: the
    droplet source ``max(0, N_act - N_liq) / dt`` over one step. The modes
    are summed in their order."""
    total = functools.reduce(operator.add, n_act)
    return torch.where(q_liq > 0, torch.maximum(N_liq, total), N_liq)


def activation_step(aa, layout: Layout, state, ap, aip, tps, ad):
    """One step on ``state`` with the activation module ``aa`` (the frozen
    one, or the program's) and the distribution ``ad``: ``(n_act, m_act,
    N_liq)``."""
    air = layout.air(state)
    n_act = aa.N_activated_per_mode(ap, ad, aip, tps, *air)
    m_act = aa.M_activated_per_mode(ap, ad, aip, tps, *air)
    return n_act, m_act, host_update(state.q_liq, state.N_liq, n_act)


def step(layout: Layout, state, ap, aip, tps):
    """The frozen step: the frozen activation on the frozen classes."""
    return activation_step(AA, layout, state, ap, aip, tps,
                           layout.distribution(state))
