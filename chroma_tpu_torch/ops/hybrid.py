"""Hybrid photon-map rendering (counterpart of chroma_tpu/ops/hybrid.py;
parity: chroma/cuda/hybrid_render.cu).

Two passes over the same photon physics:

  * ``update_xyz_lookup`` traces photons from a point light to their
    first DIFFUSE reflection and accumulates cos-weighted RGB into a
    per-triangle irradiance map, split by which side of the surface
    was lit (reference hybrid_render.cu:64 update_xyz_lookup, with the
    float atomics replaced by ``index_add_``);
  * ``render`` traces camera rays through specular/refractive transport
    to their first diffuse hit and reads the map (reference
    hybrid_render.cu:134 update_xyz_image).

``to_diffuse`` is the reference's photon loop that stops on
REFLECT_DIFFUSE (hybrid_render.cu:19), a host loop over
``propagate_step``.  The packed tables hold no per-triangle vertex copy:
triangle corners are gathered from ``vertices[triangles[idx]]``.
"""
import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.ops import mbvh
from chroma_tpu_torch.ops.intersect import cross, dot
from chroma_tpu_torch.ops.propagate import (NDRAWS, alive_mask, i32,
                                            make_photon_state,
                                            propagate_step)

# (wavelength nm, rgb weight) samples approximating the eye's response
RGB_WAVELENGTHS = ((685.0, (1.0, 0.0, 0.0)),
                   (545.0, (0.0, 1.0, 0.0)),
                   (445.0, (0.0, 0.0, 1.0)))


def triangle_corners(geom, tri):
    """(n, 3, 3) corner positions of triangles ``tri`` (clamped at 0)."""
    return geom.vertices[geom.triangles[torch.clamp(tri, min=0).long()]
                         .long()]


def to_diffuse(state, geom, generator, max_steps=10):
    """Propagate until the first diffuse reflection (or death), drawing
    one (n, NDRAWS) block of uniforms per step from ``generator``.

    Returns (diffuse, tri, outward): who reflected diffusely, off
    which triangle, and whether the lit side faces along the stored
    geometric normal.
    """
    n = state['pos'].shape[0]
    dev = state['pos'].device
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    outward = torch.zeros(n, dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps and bool(
            (alive_mask(state['flags']) & ~done).any()):
        u = torch.rand((n, NDRAWS), generator=generator, device=dev)
        new_state = propagate_step(state, geom, u, 0)
        newly = ~done & ((new_state['flags']
                          & i32(event.REFLECT_DIFFUSE)) != 0)
        tri = torch.where(newly, new_state['last_hit_triangle'], tri)
        # side: the diffuse direction points into the half-space the
        # light arrived from; compare with the geometric normal
        tv = triangle_corners(geom, tri)
        gnorm = cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        outward = torch.where(newly, dot(gnorm, new_state['dir']) > 0.0,
                              outward)
        done = done | newly
        # freeze finished photons so later steps skip them
        flags = torch.where(done & alive_mask(new_state['flags']),
                            new_state['flags'] | i32(event.NO_HIT),
                            new_state['flags'])
        state = dict(new_state, flags=flags)
        step += 1
    return done, tri, outward


def _random_pol(dirv, generator):
    """Unit polarizations perpendicular to ``dirv``, from normal draws."""
    u = torch.randn(dirv.shape, generator=generator, device=dirv.device)
    pol = cross(u, dirv)
    return pol / torch.clamp(
        torch.linalg.norm(pol, dim=1, keepdim=True), min=1e-12)


def _photon_state_to(targets, source, wavelength, generator):
    n = targets.shape[0]
    dirv = targets - source[None, :]
    dirv = dirv / torch.linalg.norm(dirv, dim=1, keepdim=True)
    return _ray_state(source.expand(n, 3), dirv, wavelength, generator)


def _ray_state(pos, dirv, wavelength, generator):
    n = pos.shape[0]
    dev = pos.device
    return make_photon_state(
        pos=pos, dir=dirv, pol=_random_pol(dirv, generator),
        wavelength=torch.full((n,), wavelength, dtype=torch.float32,
                              device=dev),
        t=torch.zeros(n, dtype=torch.float32, device=dev), device=dev)


class HybridRenderer(object):
    """Progressive photon-map renderer over a packed geometry, on the
    device its tables live on."""

    def __init__(self, gpu_geometry, max_steps=10, seed=0):
        self.geom = gpu_geometry.geom
        self.device = self.geom.vertices.device
        self.ntriangles = int(self.geom.triangles.shape[0])
        self.max_steps = max_steps
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.clear_lookup()

    def clear_lookup(self):
        # xyz irradiance per triangle, one table per lit side
        # (reference keeps xyz_lookup1/xyz_lookup2)
        self.lookup = [torch.zeros((self.ntriangles, 3),
                                   dtype=torch.float32, device=self.device)
                       for _ in (0, 1)]
        self.nlookup_calls = 0

    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def _uniform(self, n):
        return torch.rand((n, 1), generator=self.generator,
                          device=self.device)

    def update_xyz_lookup(self, source_position, chunk=1 << 17):
        """One photon toward a random point of every triangle, traced
        to its diffuse sink (reference hybrid_render.cu:64)."""
        source = self._f32(source_position)
        for wavelength, rgb in RGB_WAVELENGTHS:
            rgb = self._f32(rgb)
            for start in range(0, self.ntriangles, chunk):
                stop = min(start + chunk, self.ntriangles)
                n = stop - start
                a = self._uniform(n)
                b = self._uniform(n) * (1.0 - a)
                c = 1.0 - a - b
                ids = torch.arange(start, stop, dtype=torch.int32,
                                   device=self.device)
                sub = triangle_corners(self.geom, ids)
                target = a * sub[:, 0] + b * sub[:, 1] + c * sub[:, 2]
                state = _photon_state_to(target, source, wavelength,
                                         self.generator)

                # visibility: the first boundary must be the targeted
                # triangle, so nearer geometry doesn't double-count
                hit = mbvh.intersect_mesh(state['pos'], state['dir'],
                                          self.geom)
                visible = hit['triangle'] == ids

                gnorm = cross(sub[:, 1] - sub[:, 0], sub[:, 2] - sub[:, 0])
                gnorm = gnorm / torch.clamp(
                    torch.linalg.norm(gnorm, dim=1, keepdim=True),
                    min=1e-12)
                cos_theta = torch.abs(dot(gnorm, state['dir']))

                diffuse, tri, outward = to_diffuse(
                    state, self.geom, self.generator,
                    max_steps=self.max_steps)
                keep = diffuse & visible
                w = torch.where(keep, cos_theta, 0.0)[:, None] \
                    * rgb[None, :]
                idx = torch.clamp(tri, min=0).long()
                for side in (0, 1):
                    sw = torch.where((outward == bool(side))[:, None],
                                     w, 0.0)
                    self.lookup[side].index_add_(0, idx, sw)
        self.nlookup_calls += 1

    def render(self, rays_pos, rays_dir, nimages=1):
        """(N,3) float image for camera rays through the photon map
        (reference hybrid_render.cu:134 + process_image)."""
        n = rays_pos.shape[0]
        image = torch.zeros((n, 3), dtype=torch.float32,
                            device=self.device)
        for wavelength, rgb in RGB_WAVELENGTHS:
            rgb = self._f32(rgb)
            state = _ray_state(rays_pos, rays_dir, wavelength,
                               self.generator)
            diffuse, tri, outward = to_diffuse(
                state, self.geom, self.generator, max_steps=self.max_steps)
            idx = torch.clamp(tri, min=0).long()
            table = torch.where(outward[:, None],
                                self.lookup[1][idx], self.lookup[0][idx])
            contrib = torch.where(diffuse[:, None], table * rgb[None, :],
                                  0.0)
            image = image + contrib / max(self.nlookup_calls, 1)
        return image / nimages

    def process_image(self, image, scale=1.0):
        """float (N,3) -> uint32 ARGB pixels (hybrid_render.cu:171)."""
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        rgb = (np.clip(np.asarray(image) * scale, 0.0, 1.0)
               * 255.0).astype(np.uint32)
        return (np.uint32(255) << 24 | rgb[:, 0] << 16
                | rgb[:, 1] << 8 | rgb[:, 2])
