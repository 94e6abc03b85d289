"""ZMQ photon-propagation service (counterpart of chroma_tpu/cli/server.py;
parity: reference bin/chroma-server and bin/chroma-server-rat).

Two protocols on a REP socket:
  * pickle (default): recv a Photons object, reply with the propagated
    Photons (photons_end);
  * --rat: the packed-binary protocol spoken by RAT's C++ client
    (uint32 header [nphotons, eventid], 11 double arrays, uint32
    track ids; reply = detected hit photons + channel indices).

The work of one request is ``answer``; ``serve_forever`` is the socket
loop around it.  With ``address=None`` a server opens no socket (and
needs no pyzmq) and answers through ``answer`` alone.
"""
import argparse

import numpy as np


class ChromaServer(object):
    """Pickle-protocol propagation server."""

    def __init__(self, address, detector, geant4_processes=0, device=None):
        from chroma_tpu_torch.sim import Simulation
        self.context = self.socket = None
        self.address = address
        self.sim = Simulation(detector, geant4_processes=geant4_processes,
                              device=device)
        if address is not None:
            import zmq
            self.context = zmq.Context()
            self.socket = self.context.socket(zmq.REP)
            self.socket.bind(address)

    def answer(self, photons_in):
        """The propagated Photons for one request's Photons."""
        ev = next(self.sim.simulate(photons_in, keep_photons_end=True))
        return ev.photons_end

    def serve_one(self):
        photons_in = self.socket.recv_pyobj()
        print('Processing', len(photons_in), 'photons')
        self.socket.send_pyobj(self.answer(photons_in))

    def serve_forever(self):
        while True:
            self.serve_one()

    def close(self):
        """Close the socket and end the simulation's workers."""
        if self.socket is not None:
            from chroma_tpu_torch.generator.photon import unlink_ipc
            self.socket.close(linger=0)
            self.context.term()
            self.socket = self.context = None
            unlink_ipc(self.address)
        self.sim.close()


class ChromaRATServer(ChromaServer):
    """Packed-binary protocol server for RAT C++ clients."""

    @staticmethod
    def unpack(msg):
        from chroma_tpu_torch.event import Photons
        nphotons, eventid = np.frombuffer(msg[:8], dtype=np.uint32)
        doubles = np.frombuffer(msg[8:8 + 8 * 11 * nphotons],
                                dtype=np.double)
        x, y, z, dx, dy, dz, px, py, pz, wavelen, t = np.split(doubles, 11)
        photons = Photons(np.vstack((x, y, z)).T,
                          np.vstack((dx, dy, dz)).T,
                          np.vstack((px, py, pz)).T, wavelen, t)
        return photons, eventid

    @staticmethod
    def pack(hitphotons, chanidxes, eventid):
        reply = np.asarray([len(hitphotons), eventid],
                           dtype=np.uint32).tobytes()
        p = hitphotons
        for arr in (p.pos[:, 0], p.pos[:, 1], p.pos[:, 2],
                    p.dir[:, 0], p.dir[:, 1], p.dir[:, 2],
                    p.pol[:, 0], p.pol[:, 1], p.pol[:, 2],
                    p.wavelengths, p.t):
            reply += np.asarray(arr, dtype=np.double).tobytes()
        reply += chanidxes.tobytes()
        reply += chanidxes.tobytes()  # track-id standin, as upstream
        return reply

    def answer(self, msg):
        """The packed reply (detected hits sorted by channel) for one
        packed request."""
        photons, eventid = self.unpack(msg)
        print('Received', len(photons), 'photons for event', eventid)
        ev = next(self.sim.simulate(photons, keep_flat_hits=True,
                                    max_steps=1000))
        hits = ev.flat_hits
        hits = hits[np.argsort(hits.channel)]
        return self.pack(hits, hits.channel.astype(np.uint32), eventid)

    def serve_one(self):
        self.socket.send(self.answer(self.socket.recv()))


def main(argv=None):
    parser = argparse.ArgumentParser('chroma-torch-server')
    parser.add_argument('detector', help='geometry identifier string')
    parser.add_argument('--address', '-a', default='tcp://*:5024')
    parser.add_argument('--rat', action='store_true',
                        help='speak the packed-binary RAT protocol')
    parser.add_argument('-g', type=int, dest='ngenerators', default=0)
    parser.add_argument('--device', default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                             'PyTorch versions')
    args = parser.parse_args(argv)

    from chroma_tpu_torch.loader import load_geometry_from_string
    print('reticulating splines...')
    detector = load_geometry_from_string(args.detector)
    cls = ChromaRATServer if args.rat else ChromaServer
    server = cls(args.address, detector,
                 geant4_processes=args.ngenerators, device=args.device)
    print('starting chroma_tpu_torch server listening on', args.address)
    try:
        server.serve_forever()
    finally:
        server.close()


if __name__ == '__main__':
    main()
