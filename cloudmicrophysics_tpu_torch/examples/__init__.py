"""The reference's validation cases on the port, one module per script of
the JAX package's ``examples/``, under the script's own name.

Each module has ``run(device=None, dtype=torch.float64, ...)``, returning
the numbers the script prints, unrounded, as a dict (the run lengths are
keyword arguments, the script's own values by default), and
``main(argv=None)``, printing the script's lines. ``python -m
cloudmicrophysics_tpu_torch.examples.<name>`` runs one on CUDA unless
``--device cpu`` is given; ``python -m cloudmicrophysics_tpu_torch.examples``
runs them all in order and prints each one's wall seconds and steps/s.
"""

# in the JAX scripts' order (examples/README.md)
NAMES = ("parcel_liquid_only", "parcel_aerosol_activation",
         "parcel_immersion_freezing", "parcel_deposition_nucleation",
         "parcel_p3_ice_nuc", "parcel_p3_vs_activitybased",
         "parcel_jensen_2022", "parcel_frostenberg_immersion",
         "parcel_noneq", "parcel_tully_2023", "box_alpert_knopf_2016",
         "column_squall_p3")
