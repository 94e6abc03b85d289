"""Host ms a call spends joining its events' photons into one batch and
their bounds (the program's span ``simulate.join``), over the untraced
rest of the window.  Layer: sim.Simulation.simulate."""
from portbench.program_spans import instrument, per_call_ms  # noqa: F401


def read(ctx):
    return per_call_ms(ctx, 'simulate.join')
