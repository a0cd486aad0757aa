"""``setup.program_s``: seconds of the run's set-up that the program itself
spent, by its counters over the whole process: kernel libraries built
(``kernels.build_s``, ``nvcc``) and loaded (``kernels.load_s``: load,
binding and each library's first launch), and parameter sets and blocks
made (``setup.params_s``). The rest of ``setup_s`` is the interpreter,
torch's import, the CUDA context, the seeded state, the warm-up's own
steps and the harness."""

from bench_h100.spans import registry

COUNTERS = ("kernels.build_s", "kernels.load_s", "setup.params_s")


def read(view):
    trace = registry()
    if trace is None:
        return None
    return float(sum(trace.counter(name) for name in COUNTERS))
