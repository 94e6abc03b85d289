"""Alpha-depth geometry rendering (counterpart of chroma_tpu/ops/render.py;
reference: chroma/cuda/render.cu + chroma/gpu/render.py).

The reference collects the alpha_depth nearest hits per ray inside one
traversal with a per-thread sorted insertion list; here depth layers are
peeled instead: each pass finds the closest hit with the MBVH walker
(one ``intersect_mesh`` call, so one walker-kernel launch on the card),
shades it (cosine shading, reference render.cu get_color), composites
front-to-back, and advances the ray origin just past the hit.
"""
import numpy as np
import torch

from chroma_tpu_torch.device import resolve
from chroma_tpu_torch.ops import mbvh
from chroma_tpu_torch.ops.intersect import normalize, dot
from chroma_tpu_torch.transform import make_rotation_matrix


def _channel(rgba, shift):
    """Byte ``shift`` bits up in the uint32 bits that int32 ``rgba``
    holds (the mask undoes the arithmetic shift's sign extension)."""
    return (rgba >> shift) & 0xFF


def render(origin, direction, geom, alpha_depth=10, bg_color=0x66666666):
    """Render rays against the geometry; returns (N,) ARGB pixels as an
    int64 tensor holding the uint32 values."""
    n = origin.shape[0]
    dev = origin.device
    # written out term by term: the same bits on the card and the CPU
    direction = normalize(direction)

    pos = origin
    transmit = torch.ones(n, dtype=torch.float32, device=dev)
    rgb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    any_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(alpha_depth):
        res = mbvh.intersect_mesh(pos, direction, geom)
        hit = res['triangle'] >= 0
        # cosine-shaded RGB + alpha from the hit color (render.cu:12)
        rgba = geom.colors[torch.clamp(res['triangle'], min=0).long()]
        # guard the zero normal of missed rays (0/0 -> NaN would poison
        # the accumulator through 0 * NaN)
        normal = normalize(res['normal']
                           + torch.where(hit, 0.0, 1.0)[:, None])
        cos_theta = torch.abs(dot(normal, -direction))
        rgb = torch.stack([_channel(rgba, 16), _channel(rgba, 8),
                           _channel(rgba, 0)], dim=-1).to(torch.float32) \
            * cos_theta[:, None]
        alpha = (255 - _channel(rgba, 24)).to(torch.float32) / 255.0

        contrib = torch.where(hit, transmit * alpha, zero)
        rgb_acc = rgb_acc + contrib[:, None] * rgb
        transmit = torch.where(hit, transmit * (1.0 - alpha), transmit)
        # step past the hit for the next depth layer; a miss has
        # distance inf, which must not meet the 0 of the where
        step = torch.where(hit, res['distance'] + 1e-3, zero)
        pos = pos + step[:, None] * direction
        any_hit = any_hit | hit

    # blend remaining transmission with the background
    bg = torch.tensor([(bg_color >> 16) & 0xFF, (bg_color >> 8) & 0xFF,
                       bg_color & 0xFF], dtype=torch.float32, device=dev)
    rgb = rgb_acc + transmit[:, None] * bg[None, :]
    rgb = torch.where(any_hit[:, None], rgb, bg[None, :])
    rgb = torch.clamp(rgb, 0, 255).to(torch.int64)
    return 0xFF000000 | (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]


class GPURays(object):
    """Camera ray buffers + transforms (reference: chroma/gpu/render.py
    GPURays; the CUDA transform kernels become tensor expressions)."""

    def __init__(self, pos, dir, max_alpha_depth=10, nblocks=None,
                 device=None):
        self.device = resolve(device)
        self.pos = self._f32(pos)
        self.dir = self._f32(dir)
        self.max_alpha_depth = max_alpha_depth

    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def rotate(self, phi, n):
        rot = self._f32(make_rotation_matrix(phi, n))
        self.pos = self.pos @ rot.T
        self.dir = self.dir @ rot.T

    def rotate_around_point(self, phi, n, point):
        rot = self._f32(make_rotation_matrix(phi, n))
        point = self._f32(point)
        self.pos = (self.pos - point) @ rot.T + point
        self.dir = self.dir @ rot.T

    def translate(self, v):
        self.pos = self.pos + self._f32(v)

    def render(self, gpu_geometry, pixels=None, alpha_depth=10,
               keep_last_render=False):
        """Returns (N,) ARGB pixel values (int64 tensor, uint32 range)."""
        return render(self.pos, self.dir, gpu_geometry.geom,
                      alpha_depth=alpha_depth)

    def snapshot(self, gpu_geometry, alpha_depth=10):
        """(N,) uint32 ARGB pixels on the host."""
        return self.render(gpu_geometry, alpha_depth=alpha_depth) \
            .cpu().numpy().astype(np.uint32)
