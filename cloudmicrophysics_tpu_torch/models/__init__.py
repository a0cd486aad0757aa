"""Model layer (L5/L6): fused tendency API and the column step."""

from . import column, tendencies
from .column import Column1MStep, ColumnState, step_column_1m
from .tendencies import (
    SourceTerms1M,
    Tendencies1M,
    bulk_tendencies_0m,
    bulk_tendencies_1m,
)
