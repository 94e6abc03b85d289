"""Share of the step loop's photon-steps whose physics ran in the CUDA
kernel csrc/physics_step.cu: the program's counter
``step.physics_kernel_photons`` (the photons of each ``physics_update``
call the kernel served) over ``step.live_photons``, in the untraced rest
of the window.  None where the program counts no kernel photons (a
program without the kernel, or one on the plain path).  Layer:
ops/propagate.physics_update."""
from portbench.program_spans import instrument  # noqa: F401


def read(ctx):
    part = ctx['rest']
    rec = getattr(part['counters'], 'program', None) if part else None
    if rec is None or 'step.physics_kernel_photons' not in rec.counts \
            or not rec.counts.get('step.live_photons'):
        return None
    return rec.counts['step.physics_kernel_photons'] \
        / rec.counts['step.live_photons']
