"""Model layer (L5/L6): fused tendency API and the column step."""

from . import column, p3_tendencies, tendencies
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
from .p3_tendencies import P3StepAux, ice_tendencies_2m_p3, p3_step_aux
from .tendencies import (
    SourceTerms1M,
    Tendencies1M,
    Tendencies2M,
    bulk_microphysics_tendencies,
    bulk_tendencies_0m,
    bulk_tendencies_1m,
    bulk_tendencies_2m,
)
