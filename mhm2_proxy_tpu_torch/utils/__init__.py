from .synth import random_genome, simulate_reads  # noqa: F401
from .logger import get_logger, SLOG  # noqa: F401
