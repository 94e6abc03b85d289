"""Host ms a call spends splitting its batch into events: each event's
hits mask and channels download (the program's span
``simulate.debatch``, one an event, summed over the call), over the
untraced rest of the window.  Layer: sim.Simulation.simulate."""
from portbench.program_spans import instrument, per_call_ms  # noqa: F401


def read(ctx):
    return per_call_ms(ctx, 'simulate.debatch')
