"""Model layer (L5/L6): fused tendency API, the column steps, the 0-D
drivers, calibration and the activation emulators."""

from . import (
    aida,
    box,
    calibration,
    column,
    emulator,
    p3_sandbox,
    p3_tendencies,
    parcel,
    tendencies,
)
from .calibration import (
    EKIResult,
    calibrate_abifm,
    eki_calibrate,
    uki_calibrate,
)
from .column import (
    Column1MStep,
    Column2MStep,
    ColumnP3Step,
    ColumnState,
    ColumnState2M,
    ColumnStateP3,
    step_column_1m,
    step_column_2m,
    step_column_p3,
)
from .box import BoxState, run_box, run_box_stochastic
from .p3_sandbox import P3SandboxState, run_p3_sandbox
from .p3_tendencies import P3StepAux, ice_tendencies_2m_p3, p3_step_aux
from .parcel import (
    ParcelParams,
    ParcelState,
    parcel_params,
    parcel_tendencies,
    run_parcel,
)
from .tendencies import (
    SourceTerms1M,
    Tendencies1M,
    Tendencies2M,
    bulk_microphysics_tendencies,
    bulk_tendencies_0m,
    bulk_tendencies_1m,
    bulk_tendencies_2m,
)
