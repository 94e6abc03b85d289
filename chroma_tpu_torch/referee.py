"""Checks of the port's physics that need no other package.

``run_referee`` runs the two checks of chroma_tpu/referee.py at each
lane width of ``WIDTHS``:

1. terminal passthrough: photons that are terminal on arrival must
   leave ``propagate_fused`` with every word bit-exact: denormal
   floats, NaN payloads in pos/dir and every flag bit.  A float select
   or a flush-to-zero anywhere in the driver's pack, retire or unpack
   plumbing corrupts them.  Run with one and with two on-deck slots.
2. kernel against plain walker (the JAX package's pallas-vs-jnp): live
   photons through ``propagate_fused`` with the CUDA window kernel and
   with ``plain_walker=True``, from one generator seed, must come out
   bit-equal in every field, at the first two widths.  On CPU tensors
   both runs take the plain walker, so the check compares it with
   itself, and its log line says so.

Run directly:  python -m chroma_tpu_torch.referee [tiny|full]
(on the card; exits 1 on a failure).

The gate-box checks (``gate_box_checks``): each gated physics model
(bulk reemission, WLS, dichroic and thin-film surfaces) in its
``host.gate_box`` scene through ``GPUPhotons.propagate``, its one-step
outcome fractions against the probabilities the scene specifies, and
weighted against unweighted detection.
"""
import sys

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops import fused

WIDTHS = (2048, 4096, 8192)
# walker iterations between service passes in the referee's runs
_SE = 4


def adversarial_terminal_state(n, seed=3):
    """chroma_tpu/referee.py ``_adversarial_terminal_state`` in numpy:
    the same bit patterns, with flags and evidx as int32 holding the
    uint32 bits (the port's photon state dtypes)."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 1 << 31, size=(n, 16), dtype=np.int64) \
        .astype(np.uint32)
    bits = bits * np.uint32(2) + (np.arange(n)[:, None] & 1).astype(
        np.uint32)
    pos = bits[:, 0:3].view(np.float32).copy()
    dirv = bits[:, 3:6].view(np.float32).copy()
    pol = bits[:, 6:9].view(np.float32).copy()
    pos[::7, 0] = np.float32(1.4e-45)
    pos[1::7, 1] = np.uint32(0x007fffff).view(np.float32)
    dirv[2::7, 2] = np.float32(np.nan)
    flags = (bits[:, 12] | np.uint32(event.BULK_ABSORB)).astype(np.uint32)
    flags[::3] |= np.uint32(event.SURFACE_DETECT)
    return dict(
        pos=pos, dir=dirv, pol=pol,
        wavelength=bits[:, 9].view(np.float32).copy(),
        t=bits[:, 10].view(np.float32).copy(),
        weight=np.full(n, np.uint32(1)).view(np.float32).copy(),
        flags=flags.view(np.int32),
        last_hit_triangle=bits[:, 13].view(np.int32).copy(),
        evidx=(bits[:, 14] >> np.uint32(8)).view(np.int32),
        index=np.arange(n, dtype=np.int64))


def live_state(n, seed=5):
    """chroma_tpu/referee.py ``_live_state`` in numpy: ``n`` live
    photons from the origin in random directions."""
    rng = np.random.RandomState(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    return dict(
        pos=np.zeros((n, 3), np.float32), dir=dirs, pol=pol,
        wavelength=rng.uniform(300, 600, n).astype(np.float32),
        t=np.zeros(n, np.float32), weight=np.ones(n, np.float32),
        flags=np.zeros(n, np.int32),
        last_hit_triangle=np.full(n, -1, np.int32),
        evidx=np.zeros(n, np.int32), index=np.arange(n, dtype=np.int64))


def _diff_keys(a, b):
    """Names (with the count of differing 32-bit words) of the fields
    of ``b`` that are not bit-equal to those of ``a``; numpy arrays or
    tensors."""
    bad = []
    for k in a:
        va = np.ascontiguousarray(_numpy(a[k]))
        vb = np.ascontiguousarray(_numpy(b[k]))
        if not (va.shape == vb.shape and va.dtype == vb.dtype
                and np.array_equal(va.view(np.uint8), vb.view(np.uint8))):
            nd = int(np.sum(va.view(np.uint32) != vb.view(np.uint32))) \
                if va.shape == vb.shape and va.dtype == vb.dtype else -1
            bad.append('%s (%d words differ)' % (k, nd))
    return bad


def _numpy(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def terminal_passthrough(tables, n=4096, width=1024, service_every=4,
                         od_slots=1):
    """Run the adversarial state through ``propagate_fused`` on the
    tables' device.  Returns the names of the fields that did not come
    back bit-exact (empty when the check passes)."""
    dev = tables.mbvh_rows.device
    ref = adversarial_terminal_state(n)
    state = {k: torch.from_numpy(v).to(dev) for k, v in ref.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out, _ = fused.propagate_fused(
        state, tables, fused.uniform_draws(gen), max_steps=10, width=width,
        service_every=service_every, od_slots=od_slots)
    return [k.split()[0] for k in _diff_keys(ref, out)]


def kernel_against_plain(tables, n, width, seed=11):
    """Live photons (``live_state``) through ``propagate_fused`` with the
    window kernel and with the plain walker, each from a generator
    seeded with ``seed``; returns ``_diff_keys`` of the two results."""
    dev = tables.mbvh_rows.device
    outs = []
    for plain in (False, True):
        state = {k: torch.from_numpy(v).to(dev)
                 for k, v in live_state(n).items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out, _ = fused.propagate_fused(
            state, tables, fused.uniform_draws(gen), max_steps=16,
            width=width, service_every=_SE, plain_walker=plain)
        outs.append(out)
    return _diff_keys(*outs)


def run_referee(tables, widths=WIDTHS, verbose=True,
                checks=('terminal', 'crosswalk')):
    """Run the selected checks against packed tables ``tables`` on their
    device; returns a list of failure strings (empty = pass)."""
    failures = []
    on_card = tables.mbvh_rows.device.type == 'cuda'

    def log(msg):
        if verbose:
            print('[referee] ' + msg, flush=True)

    for w in widths if 'terminal' in checks else ():
        for od_slots in (1, 2):
            bad = terminal_passthrough(tables, n=2 * w, width=w,
                                       service_every=_SE, od_slots=od_slots)
            if bad:
                failures.append('terminal passthrough w=%d od_slots=%d: %s'
                                % (w, od_slots, ', '.join(bad)))
            log('terminal passthrough w=%-5d od_slots=%d %s'
                % (w, od_slots, 'FAIL' if bad else 'ok'))
    for w in widths[:2] if 'crosswalk' in checks else ():
        bad = kernel_against_plain(tables, 2 * w, w)
        if bad:
            failures.append('kernel-vs-plain w=%d: %s' % (w, ', '.join(bad)))
        log('kernel-vs-plain     w=%-5d %s%s'
            % (w, 'FAIL' if bad else 'ok', '' if on_card else
               ' (CPU tensors: the plain walker against itself, no '
               'kernel ran)'))
    return failures


def main(argv=None):
    """``python -m chroma_tpu_torch.referee [tiny|full]``: both checks
    on the demo detector's tables (from the table cache, built on a
    miss) on the card; exits 1 on a failure."""
    from chroma_tpu_torch import demo, gpu
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else 'tiny'
    if which not in ('tiny', 'full'):
        raise SystemExit('usage: python -m chroma_tpu_torch.referee '
                         '[tiny|full]')
    gg = gpu.GPUDetector.from_table_cache(which)
    if gg is None:
        geo = demo.detector() if which == 'full' else demo.tiny()
        geo.flatten()
        gg = gpu.GPUDetector(geo)
    failures = run_referee(gg.geom)
    if failures:
        print('[referee] FAILED:')
        for f in failures:
            print('  ' + f)
        sys.exit(1)
    print('[referee] all checks passed')


def _flag_fraction(flags, bit):
    return float(((flags & np.uint32(bit)) != 0).mean())


def gate_box_checks(gate, device, n=200000, seed=0):
    """Statistical checks of one gated physics model on ``device``.

    Returns a list of (what, observed, expected, sigma): the check holds
    when |observed - expected| is within the caller's number of sigmas.
    Photons go through ``GPUPhotons.propagate`` with its default, the
    on-deck driver.

    * one step (``max_steps=1``) of ``n`` beam photons onto the gate
      surface (or through the scintillator): the share of photons with
      each outcome flag against the probability the scene specifies
      (binomial sigma), and the mean reemitted wavelength against the
      spectrum's peak;
    * ``n`` isotropic photons, 30 steps, unweighted and with
      ``use_weights=True``: the sum of weights of the detected photons
      against the unweighted detected count.  For the thin-film gate
      this runs on a film that does not detect: the model's forced
      detection weighs a photon by detect / absorb(normal incidence)
      without the film's own absorption probability (as the reference
      does, chroma/cuda/photon.h propagate_complex), so it does not
      estimate the unweighted count.
    """
    from chroma_tpu_torch import gpu, host
    E = event
    out = []

    def run(geo, photons, rng_seed, **kw):
        gg = gpu.GPUGeometry(geo, device)
        p = gpu.GPUPhotons(photons, device)
        p.propagate(gg, gpu.get_rng_states(seed=rng_seed, device=device),
                    **kw)
        return p.get()

    def fraction(p, what, bit, q):
        out.append(('%s: %s share after one step' % (gate, what),
                    _flag_fraction(p.flags, bit), q,
                    np.sqrt(max(q * (1.0 - q), 1e-6) / n)))

    # ---- one-step outcome fractions ----------------------------------
    if gate == 'reemission':
        p = run(host.gate_box(gate), host.beam_photons(n, wavelength=250.0),
                seed + 1, max_steps=1)
        absorbed = 1.0 - np.exp(-50.0 / host.SCINT_ABSORPTION)
        fraction(p, 'BULK_REEMIT', E.BULK_REEMIT,
                 absorbed * host.SCINT_REEMIT)
        fraction(p, 'BULK_ABSORB', E.BULK_ABSORB,
                 absorbed * (1.0 - host.SCINT_REEMIT))
        wl = p.wavelengths[(p.flags & E.BULK_REEMIT) != 0]
    elif gate == 'wls':
        p = run(host.gate_box(gate), host.beam_photons(n), seed + 1,
                max_steps=1)
        fraction(p, 'SURFACE_ABSORB', E.SURFACE_ABSORB,
                 host.WLS_ABSORB * (1.0 - host.WLS_REEMIT))
        fraction(p, 'SURFACE_REEMIT', E.SURFACE_REEMIT,
                 host.WLS_ABSORB * host.WLS_REEMIT)
        fraction(p, 'REFLECT_SPECULAR', E.REFLECT_SPECULAR, host.WLS_RSPEC)
        fraction(p, 'REFLECT_DIFFUSE', E.REFLECT_DIFFUSE, host.WLS_RDIFF)
        fraction(p, 'SURFACE_TRANSMIT', E.SURFACE_TRANSMIT,
                 1.0 - host.WLS_ABSORB - host.WLS_RSPEC - host.WLS_RDIFF)
        wl = p.wavelengths[(p.flags & E.SURFACE_REEMIT) != 0]
    elif gate == 'dichroic':
        theta, wavelength = 0.6, 350.0
        p = run(host.gate_box(gate),
                host.beam_photons(n, theta=theta, wavelength=wavelength),
                seed + 1, max_steps=1)
        r, t = host.dichroic_expect(theta, wavelength)
        fraction(p, 'REFLECT_SPECULAR', E.REFLECT_SPECULAR, r)
        fraction(p, 'SURFACE_TRANSMIT', E.SURFACE_TRANSMIT, t)
        fraction(p, 'SURFACE_ABSORB', E.SURFACE_ABSORB, 1.0 - r - t)
        wl = None
    elif gate == 'complex':
        qe = 0.2
        p = run(host.gate_box(gate, film_detect=qe), host.beam_photons(n),
                seed + 1, max_steps=1)
        r, t = host.film_normal_rt(1.0, 1.0, 400.0)
        fraction(p, 'SURFACE_DETECT', E.SURFACE_DETECT, qe)
        fraction(p, 'SURFACE_ABSORB', E.SURFACE_ABSORB, 1.0 - r - t - qe)
        fraction(p, 'REFLECT_DIFFUSE', E.REFLECT_DIFFUSE,
                 r * host.FILM_RDIFF)
        fraction(p, 'REFLECT_SPECULAR', E.REFLECT_SPECULAR,
                 r * (1.0 - host.FILM_RDIFF))
        fraction(p, 'SURFACE_TRANSMIT', E.SURFACE_TRANSMIT, t)
        wl = None
    else:
        raise ValueError('gate must be one of %s, got %r'
                         % (host.GATES, gate))
    if wl is not None:
        out.append(('%s: mean reemitted wavelength of %d photons, nm'
                    % (gate, len(wl)),
                    float(wl.mean()) if len(wl) else float('nan'),
                    host.REEMIT_PEAK,
                    host.REEMIT_WIDTH / np.sqrt(max(len(wl), 1))))

    # ---- weighted against unweighted detection -----------------------
    geo = host.gate_box(gate)
    np.random.seed(seed + 2)
    bomb = host.photon_bomb(n, 400.0, (0.0, 0.0, 0.0)).photons_beg
    plain = run(geo, bomb, seed + 3, max_steps=30)
    weighted = run(geo, bomb, seed + 4, max_steps=30, use_weights=True)
    det = (plain.flags & np.uint32(E.SURFACE_DETECT)) != 0
    wdet = weighted.weights * ((weighted.flags
                                & np.uint32(E.SURFACE_DETECT)) != 0)
    out.append(('%s: weighted detection sum against the unweighted count '
                'of %d photons' % (gate, n), float(wdet.sum()),
                float(det.sum()),
                float(np.sqrt(n * (det.var() + wdet.var())))))
    return out


if __name__ == '__main__':
    main()
