from .assembler import Assembler, AssemblerConfig, assemble  # noqa: F401
