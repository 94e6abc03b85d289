"""Relativistic pi0 -> 2 gamma decay kinematics (parity: chroma/pi0.py;
a copy of chroma_tpu/pi0.py for the port).

Computed directly in MeV with a Lorentz boost along the pi0 velocity
(the reference converts through kg; the physics is identical).
"""
import numpy as np

PI0_MASS = 134.9766  # MeV


def boost_to_lab(energy, momentum, v):
    """Boost (energy, momentum 3-vector) from a frame moving with
    velocity ``v`` (units of c) into the lab frame."""
    e0 = float(energy)
    p0 = np.asarray(momentum, float)
    v = np.asarray(v, float)
    beta = np.linalg.norm(v)
    if beta < 1e-12:
        return e0, p0
    nhat = v / beta
    gamma = 1.0 / np.sqrt(1.0 - beta ** 2)
    p_par = np.dot(p0, nhat)
    p = p0 + ((gamma - 1.0) * p_par + gamma * beta * e0) * nhat
    e = gamma * (e0 + beta * p_par)
    return e, p


def pi0_decay(energy, direction, theta, phi):
    """Photon energies/directions in the lab for a pi0 of total energy
    ``energy`` (MeV) moving along ``direction``, given the first
    photon's rest-frame polar angles.

    Returns ((e1, dir1), (e2, dir2))."""
    direction = np.asarray(direction) / np.linalg.norm(direction)
    pi0_e = float(energy)
    pi0_p = np.sqrt(max(pi0_e ** 2 - PI0_MASS ** 2, 0.0)) * direction
    pi0_v = pi0_p / pi0_e

    photon_e0 = PI0_MASS / 2.0
    photon_p0 = photon_e0 * np.array([np.cos(phi) * np.sin(theta),
                                      np.sin(phi) * np.sin(theta),
                                      np.cos(theta)])
    e1, p1 = boost_to_lab(photon_e0, photon_p0, pi0_v)
    e2, p2 = boost_to_lab(photon_e0, -photon_p0, pi0_v)
    return ((e1, p1 / np.linalg.norm(p1)),
            (e2, p2 / np.linalg.norm(p2)))
