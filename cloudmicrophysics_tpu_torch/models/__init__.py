"""Model layer (L5/L6): fused tendency API and the column step."""

from . import column, tendencies
from .column import (
    Column1MStep,
    Column2MStep,
    ColumnState,
    ColumnState2M,
    step_column_1m,
    step_column_2m,
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
