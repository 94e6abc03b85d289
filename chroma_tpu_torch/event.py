"""Event data model: photon bundles, particle vertices, channel readout.

Parity with the reference event model (reference: chroma/event.py) —
same photon-history bit flags (mirroring chroma/cuda/photon.h:49-64),
same ``Photons``/``Vertex``/``Event``/``Channels`` API.  A copy of
chroma_tpu/event.py for the port: photon bundles are structure-of-arrays
numpy containers that convert losslessly to the port's device state
(chroma_tpu_torch/ops/photon.py).
"""
import numpy as np

# Photon history bit flags.  These values are part of the on-disk and
# device ABI: they must match the propagation engine's flag lattice
# (reference: chroma/cuda/photon.h:49-64, chroma/event.py:5-17).
NO_HIT           = 0x1 << 0
BULK_ABSORB      = 0x1 << 1
SURFACE_DETECT   = 0x1 << 2
SURFACE_ABSORB   = 0x1 << 3
RAYLEIGH_SCATTER = 0x1 << 4
REFLECT_DIFFUSE  = 0x1 << 5
REFLECT_SPECULAR = 0x1 << 6
SURFACE_REEMIT   = 0x1 << 7
SURFACE_TRANSMIT = 0x1 << 8
BULK_REEMIT      = 0x1 << 9
CHERENKOV        = 0x1 << 10
SCINTILLATION    = 0x1 << 11
NAN_ABORT        = 0x1 << 31

# A photon with any of these flags set is terminal: the propagator will
# not step it further (reference: chroma/cuda/propagate.cu:258).
TERMINAL_FLAGS = (NO_HIT | BULK_ABSORB | SURFACE_DETECT | SURFACE_ABSORB
                  | NAN_ABORT)

PROCESS_NAMES = {
    NO_HIT: 'NO_HIT', BULK_ABSORB: 'BULK_ABSORB',
    SURFACE_DETECT: 'SURFACE_DETECT', SURFACE_ABSORB: 'SURFACE_ABSORB',
    RAYLEIGH_SCATTER: 'RAYLEIGH_SCATTER', REFLECT_DIFFUSE: 'REFLECT_DIFFUSE',
    REFLECT_SPECULAR: 'REFLECT_SPECULAR', SURFACE_REEMIT: 'SURFACE_REEMIT',
    SURFACE_TRANSMIT: 'SURFACE_TRANSMIT', BULK_REEMIT: 'BULK_REEMIT',
    CHERENKOV: 'CHERENKOV', SCINTILLATION: 'SCINTILLATION',
    NAN_ABORT: 'NAN_ABORT',
}

# Minimal PDG-code table for Geant4-convention particle names, so the
# framework does not require the external `particle` package.
_PDG_CODES = {
    'e-': 11, 'e+': -11, 'gamma': 22, 'mu-': 13, 'mu+': -13,
    'tau-': 15, 'tau+': -15, 'pi0': 111, 'pi+': 211, 'pi-': -211,
    'kaon0': 311, 'kaon+': 321, 'kaon-': -321, 'neutron': 2112,
    'proton': 2212, 'anti_proton': -2212, 'anti_neutron': -2112,
    'nu_e': 12, 'anti_nu_e': -12, 'nu_mu': 14, 'anti_nu_mu': -14,
    'nu_tau': 16, 'anti_nu_tau': -16, 'alpha': 1000020040,
    'opticalphoton': -22,
}

# Particle rest masses in MeV (Geant4 naming), used by the vertex
# generators for kinematics.
PARTICLE_MASS_MEV = {
    'e-': 0.510998950, 'e+': 0.510998950, 'gamma': 0.0,
    'mu-': 105.6583755, 'mu+': 105.6583755,
    'pi0': 134.9768, 'pi+': 139.57039, 'pi-': 139.57039,
    'proton': 938.27208816, 'neutron': 939.56542052,
    'alpha': 3727.3794066,
}


def pdg_code(particle_name):
    """PDG ID for a Geant4-convention particle name (internal table)."""
    try:
        return _PDG_CODES[particle_name]
    except KeyError:
        raise ValueError('unknown particle name: %r' % (particle_name,))


class Steps(object):
    """Recorded particle-track steps (reference: chroma/event.py:19)."""
    def __init__(self, x, y, z, t, dx, dy, dz, ke, edep, qedep):
        self.x, self.y, self.z, self.t = x, y, z, t
        self.dx, self.dy, self.dz = dx, dy, dz
        self.ke, self.edep, self.qedep = ke, edep, qedep


class Vertex(object):
    """A particle vertex to be handed to the photon generator.

    reference: chroma/event.py:33.  Positions in mm, kinetic energy in
    MeV, time in ns; ``pol=None`` means random polarization.
    """
    def __init__(self, particle_name, pos, dir, ke, t0=0.0, pol=None,
                 steps=None, children=None, trackid=-1, pdgcode=None):
        self.particle_name = particle_name
        self.pos = pos
        self.dir = dir
        self.pol = pol
        self.ke = ke
        self.t0 = t0
        self.steps = steps
        self.children = children
        self.trackid = trackid
        self.pdgcode = pdg_code(particle_name) if pdgcode is None else pdgcode

    def __repr__(self):
        return ('Vertex(%s,ke=%s,steps=%s)'
                % (self.particle_name, self.ke, bool(self.steps)))


_FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't', 'last_hit_triangles',
           'flags', 'weights', 'evidx', 'channel')


class Photons(object):
    """Structure-of-arrays photon bundle (reference: chroma/event.py:73).

    pos/dir/pol: float32 (n,3); wavelengths (nm), t (ns), weights:
    float32 (n,); last_hit_triangles: int32 (n,) with -1 = none;
    flags: uint32 history bits; evidx: uint32 index of the owning event
    inside a batched propagation; channel: uint32 detector channel (only
    meaningful for extracted hits).
    """

    def __init__(self, pos=None, dir=None, pol=None, wavelengths=None,
                 t=None, last_hit_triangles=None, flags=None, weights=None,
                 evidx=None, channel=None):
        pos = np.empty((0, 3)) if pos is None else pos
        dir = np.empty((0, 3)) if dir is None else dir
        pol = np.empty((0, 3)) if pol is None else pol
        wavelengths = np.empty((0,)) if wavelengths is None else wavelengths

        self.pos = np.asarray(pos, dtype=np.float32)
        self.dir = np.asarray(dir, dtype=np.float32)
        self.pol = np.asarray(pol, dtype=np.float32)
        self.wavelengths = np.asarray(wavelengths, dtype=np.float32)
        n = len(self.pos)

        self.t = (np.zeros(n, dtype=np.float32) if t is None
                  else np.asarray(t, dtype=np.float32))
        if last_hit_triangles is None:
            self.last_hit_triangles = np.full(n, -1, dtype=np.int32)
        else:
            self.last_hit_triangles = np.asarray(last_hit_triangles,
                                                 dtype=np.int32)
        self.flags = (np.zeros(n, dtype=np.uint32) if flags is None
                      else np.asarray(flags, dtype=np.uint32))
        self.weights = (np.ones(n, dtype=np.float32) if weights is None
                        else np.asarray(weights, dtype=np.float32))
        self.evidx = (np.zeros(n, dtype=np.uint32) if evidx is None
                      else np.asarray(evidx, dtype=np.uint32))
        self.channel = (np.zeros(n, dtype=np.uint32) if channel is None
                        else np.asarray(channel, dtype=np.uint32))

    @staticmethod
    def join(photon_list, concatenate=True):
        """Concatenate (or stack, for scalar-like entries) many bundles."""
        combine = np.concatenate if concatenate else np.asarray
        cols = {f: combine([getattr(p, f) for p in photon_list])
                for f in _FIELDS}
        return Photons(**{('wavelengths' if f == 'wavelengths' else f): v
                          for f, v in cols.items()})

    def __add__(self, other):
        return Photons.join([self, other])

    def __len__(self):
        return len(self.pos)

    def __getitem__(self, key):
        return Photons(**{f: getattr(self, f)[key] for f in _FIELDS})

    def reduced(self, reduction_factor=1.0):
        """Random subsample of ~len(self)*reduction_factor photons."""
        n = len(self)
        choice = np.random.permutation(n)[:int(n * reduction_factor)]
        return self[choice]

    def __repr__(self):
        if len(self) == 1:
            return ('Photon(pos=%s,dir=%s,pol=%s,wavelength=%s,t=%s,'
                    'last_hit_triangle=%s,flag=%s,weight=%s)'
                    % (self.pos[0], self.dir[0], self.pol[0],
                       self.wavelengths[0], self.t[0],
                       self.last_hit_triangles[0], self.flags[0],
                       self.weights[0]))
        return 'Photons[%d]' % len(self)


class Channels(object):
    """Per-channel readout for one event (reference: chroma/event.py:229)."""

    def __init__(self, hit, t, q, flags=None, evidx=None):
        self.hit = hit
        self.t = t
        self.q = q
        self.flags = flags
        self.evidx = evidx

    def hit_channels(self, return_flags=False):
        """(hit channel ids, hit times, charges[, flags])."""
        ids = self.hit.nonzero()[0]
        if return_flags:
            return ids, self.t[self.hit], self.q[self.hit], self.flags[self.hit]
        return ids, self.t[self.hit], self.q[self.hit]


class Event(object):
    """One simulated event (reference: chroma/event.py:260)."""

    def __init__(self, id=0, vertices=None, photons_beg=None,
                 photons_end=None, photon_tracks=None,
                 photon_parent_trackids=None, hits=None, flat_hits=None,
                 channels=None):
        self.id = id
        self.nphotons = None
        if vertices is None:
            self.vertices = []
        elif np.iterable(vertices):
            self.vertices = vertices
        else:
            self.vertices = [vertices]
        self.photons_beg = photons_beg
        self.photons_end = photons_end
        self.photon_tracks = photon_tracks
        self.photon_parent_trackids = photon_parent_trackids
        self.hits = hits
        self.flat_hits = flat_hits
        self.channels = channels
