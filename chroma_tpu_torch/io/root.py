"""ROOT event IO (the port's copy of chroma_tpu/io/root.py; parity:
chroma/io/root.py + io/root.C).

The reference compiles a ROOT dictionary macro (chroma/io/root.C) at
import and round-trips events through TTree branches.  ROOT is an
optional heavyweight dependency; when available we stream the same
logical schema via PyROOT (one Fill per event, as reference
io/root.py:304 does), otherwise importing RootWriter/RootReader raises
with a pointer to the native npz format, which holds the full schema.
"""
try:
    import ROOT  # noqa: F401
    HAVE_ROOT = True
except ImportError:
    HAVE_ROOT = False

if not HAVE_ROOT:
    class _Missing(object):
        def __init__(self, *args, **kwargs):
            raise ImportError(
                'PyROOT is not installed. Use chroma_tpu_torch.io.npz '
                '(NpzWriter/NpzReader) or chroma_tpu_torch.io.ntuple '
                'instead.')

    RootWriter = _Missing
    RootReader = _Missing
else:
    import numpy as np
    from chroma_tpu_torch import event

    _PHOTON_COLS = (('pos', 3, 'f'), ('dir', 3, 'f'), ('pol', 3, 'f'),
                    ('wavelengths', 1, 'f'), ('t', 1, 'f'),
                    ('last_hit_triangles', 1, 'i'), ('flags', 1, 'i'),
                    ('weights', 1, 'f'), ('evidx', 1, 'i'),
                    ('channel', 1, 'i'))

    def _make_photon_branches(tree, prefix):
        vecs = {}
        for name, width, kind in _PHOTON_COLS:
            v = ROOT.std.vector('float' if kind == 'f' else 'int')()
            vecs[name] = v
            tree.Branch(prefix + name, v)
        return vecs

    def _fill_photon_vectors(vecs, photons):
        for name, width, kind in _PHOTON_COLS:
            v = vecs[name]
            v.clear()
            if photons is None:
                continue
            arr = np.asarray(getattr(photons, name))
            if width == 3:
                arr = arr.reshape(-1)
            for x in arr:
                v.push_back(float(x) if kind == 'f' else int(x))

    def _read_photon_vectors(vecs):
        n3 = vecs['pos'].size()
        if n3 == 0:
            return None
        kw = {}
        for name, width, kind in _PHOTON_COLS:
            arr = np.array([vecs[name][i]
                            for i in range(vecs[name].size())],
                           dtype=np.float32 if kind == 'f' else np.int64)
            kw[name] = arr.reshape(-1, 3) if width == 3 else arr
        return event.Photons(**kw)

    class RootWriter(object):
        """Streams events into a TTree, one Fill per event (schema:
        reference io/root.C — photons_beg/end, flat hits, per-channel
        hits, vertices, channel readout, plus a channel-info tree)."""

        def __init__(self, filename, detector=None):
            self.file = ROOT.TFile(filename, 'RECREATE')
            self.tree = ROOT.TTree('T', 'chroma_tpu_torch events')
            from array import array
            self._id = array('i', [0])
            self.tree.Branch('id', self._id, 'id/I')
            self.beg = _make_photon_branches(self.tree, 'beg_')
            self.end = _make_photon_branches(self.tree, 'end_')
            self.flat = _make_photon_branches(self.tree, 'flat_hits_')
            self.hit_chan = ROOT.std.vector('int')()
            self.tree.Branch('hit_channels', self.hit_chan)
            self.hit_photons = _make_photon_branches(self.tree, 'hits_')
            # vertices
            self.v_part = ROOT.std.vector('string')()
            self.v_num = {k: ROOT.std.vector('float')()
                          for k in ('posx', 'posy', 'posz', 'dirx',
                                    'diry', 'dirz', 'ke', 't0')}
            self.tree.Branch('vertex_particle', self.v_part)
            for k, v in self.v_num.items():
                self.tree.Branch('vertex_' + k, v)
            # channel readout
            self.c_hit = ROOT.std.vector('int')()
            self.c_t = ROOT.std.vector('float')()
            self.c_q = ROOT.std.vector('float')()
            self.c_flags = ROOT.std.vector('int')()
            for n, v in (('chan_hit', self.c_hit), ('chan_t', self.c_t),
                         ('chan_q', self.c_q),
                         ('chan_flags', self.c_flags)):
                self.tree.Branch(n, v)
            if detector is not None:
                self.write_channel_info(detector)

        def write_channel_info(self, detector):
            ct = ROOT.TTree('CH', 'channel info')
            pos = ROOT.std.vector('float')()
            typ = ROOT.std.vector('int')()
            ct.Branch('channel_pos', pos)
            ct.Branch('channel_type', typ)
            for p in np.asarray(
                    detector.channel_index_to_position).reshape(-1):
                pos.push_back(float(p))
            for t in np.asarray(detector.channel_index_to_channel_type):
                typ.push_back(int(t))
            ct.Fill()
            self._channel_tree = ct

        def write_event(self, ev):
            self._id[0] = int(ev.id)
            _fill_photon_vectors(self.beg, ev.photons_beg)
            _fill_photon_vectors(self.end, ev.photons_end)
            _fill_photon_vectors(self.flat, ev.flat_hits)
            self.hit_chan.clear()
            if ev.hits:
                joined = event.Photons.join(
                    [ev.hits[c] for c in sorted(ev.hits)])
                for c in sorted(ev.hits):
                    for _ in range(len(ev.hits[c])):
                        self.hit_chan.push_back(int(c))
                _fill_photon_vectors(self.hit_photons, joined)
            else:
                _fill_photon_vectors(self.hit_photons, None)
            self.v_part.clear()
            for v in self.v_num.values():
                v.clear()
            for vtx in (ev.vertices or []):
                self.v_part.push_back(vtx.particle_name)
                for k, val in zip(('posx', 'posy', 'posz'), vtx.pos):
                    self.v_num[k].push_back(float(val))
                for k, val in zip(('dirx', 'diry', 'dirz'), vtx.dir):
                    self.v_num[k].push_back(float(val))
                self.v_num['ke'].push_back(float(vtx.ke))
                self.v_num['t0'].push_back(float(vtx.t0))
            for v in (self.c_hit, self.c_t, self.c_q, self.c_flags):
                v.clear()
            if ev.channels is not None:
                for h in np.asarray(ev.channels.hit):
                    self.c_hit.push_back(int(h))
                for t in np.asarray(ev.channels.t):
                    self.c_t.push_back(float(t))
                for q in np.asarray(ev.channels.q):
                    self.c_q.push_back(float(q))
                if ev.channels.flags is not None:
                    for f in np.asarray(ev.channels.flags):
                        self.c_flags.push_back(int(f))
            self.tree.Fill()      # streamed: event leaves host memory

        def close(self):
            self.file.Write()
            self.file.Close()

    class RootReader(object):
        def __init__(self, filename):
            self.file = ROOT.TFile(filename)
            self.tree = self.file.Get('T')
            self.index = -1

        def __len__(self):
            return int(self.tree.GetEntries())

        def __iter__(self):
            for i in range(len(self)):
                yield self.read_event(i)

        def read_event(self, i):
            t = self.tree
            t.GetEntry(i)
            ev = event.Event(id=int(t.id))

            def get(prefix):
                vecs = {name: getattr(t, prefix + name)
                        for name, _, _ in _PHOTON_COLS}
                return _read_photon_vectors(vecs)

            ev.photons_beg = get('beg_')
            ev.photons_end = get('end_')
            ev.flat_hits = get('flat_hits_')
            hits_flat = get('hits_')
            chan = np.array([t.hit_channels[k]
                             for k in range(t.hit_channels.size())],
                            dtype=np.int64)
            if hits_flat is not None and len(chan):
                ev.hits = {int(c): hits_flat[chan == c]
                           for c in np.unique(chan)}
            names = [str(t.vertex_particle[k])
                     for k in range(t.vertex_particle.size())]
            ev.vertices = [
                event.Vertex(
                    names[k],
                    (t.vertex_posx[k], t.vertex_posy[k],
                     t.vertex_posz[k]),
                    (t.vertex_dirx[k], t.vertex_diry[k],
                     t.vertex_dirz[k]),
                    float(t.vertex_ke[k]), t0=float(t.vertex_t0[k]))
                for k in range(len(names))]
            if t.chan_hit.size():
                nch = t.chan_hit.size()
                hit = np.array([t.chan_hit[k] for k in range(nch)],
                               bool)
                tt = np.array([t.chan_t[k] for k in range(nch)],
                              np.float32)
                qq = np.array([t.chan_q[k] for k in range(nch)],
                              np.float32)
                fl = None
                if t.chan_flags.size():
                    fl = np.array([t.chan_flags[k] for k in range(nch)],
                                  np.uint32)
                ev.channels = event.Channels(hit, tt, qq, fl)
            return ev

        def next(self):
            self.index = (self.index + 1) % len(self)
            return self.read_event(self.index)

        def prev(self):
            self.index = (self.index - 1) % len(self)
            return self.read_event(self.index)

        def current(self):
            return self.read_event(max(self.index, 0))
