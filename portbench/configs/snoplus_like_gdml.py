"""Writer of the SNO+-like detector's GDML and RATDB files.

The SNO-like detector (``sno_like_gdml``) with its heavy water replaced
by a liquid scintillator: LAB with the fluor PPO, after SNO+ Collab.,
"The SNO+ experiment", JINST 16 (2021) P08059.  The scintillator's
``<material>`` carries RAT's property names, so the program's GDML
loader reads two absorbing and reemitting components from it:
``NUM_COMP``, ``ABSLENGTHn``, ``REEMISSION_PROBn``, ``REEMITWAVEFORMn``
and the ``SCINTILLATION`` spectrum, beside ``RINDEX``, the total
``ABSLENGTH`` and ``RSLENGTH``.  Its tables come from the
configuration's ``scintillator`` entry, on a wavelength grid of their
own; everything else is the SNO-like file.
"""
import numpy as np

from portbench.configs import sno_like_gdml as sno
from portbench.reference.optics import HC_MEV_NM

# LAB (C18H30) by mass; deuterium's heavy water goes
DENSITY = 0.86
ELEMENTS = (('C', 0.8773), ('H', 0.1227))
# a reemission delay's table: 0 to WAVEFORM_SPAN decay times
WAVEFORM_SPAN = 12.0
WAVEFORM_POINTS = 97


def total_absorption(scint):
    """The total absorption length at the nodes: 1 / sum(1 / L_c)."""
    comp = np.asarray(scint['abslength_mm'], dtype=np.float64)
    return 1.0 / (1.0 / comp).sum(axis=0)


def _matrix(name, pairs):
    return ('    <matrix name="%s" coldim="2" values="%s"/>\n'
            % (name, ' '.join('%r %r' % (float(x), float(y))
                              for x, y in pairs)))


def _by_energy(name, lam, values, per_nm=False):
    """A table against wavelength as GDML gives it: against energy
    (MeV), rising.  ``per_nm`` marks a density per nm, which GDML gives
    per MeV: the loader multiplies it by hc / lambda^2 again."""
    lam = np.asarray(lam, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if per_nm:
        values = values * lam * lam / HC_MEV_NM
    order = np.argsort(-lam)
    return _matrix(name, zip(HC_MEV_NM / lam[order], values[order]))


def waveform(tau_ns):
    """(times ns, density) of an exponential delay of ``tau_ns``."""
    t = np.linspace(0.0, WAVEFORM_SPAN * tau_ns, WAVEFORM_POINTS)
    return t, np.exp(-t / tau_ns) / tau_ns


def scintillator_gdml(scint):
    """(the ``<define>`` matrices, the ``<material>`` block) of the
    scintillator described by the configuration's ``scintillator``."""
    lam = scint['wavelength_nm']
    ncomp = len(scint['abslength_mm'])
    props = [('RINDEX', 'RI_SCINT'), ('ABSLENGTH', 'ABS_SCINT'),
             ('RSLENGTH', 'RS_SCINT'), ('NUM_COMP', 'NCOMP_SCINT'),
             ('SCINTILLATION', 'SPECTRUM_SCINT')]
    define = [
        _by_energy('RI_SCINT', lam, np.full(len(lam), scint['rindex'])),
        _by_energy('ABS_SCINT', lam, total_absorption(scint)),
        _by_energy('RS_SCINT', lam, scint['rslength_mm']),
        '    <matrix name="NCOMP_SCINT" coldim="1" values="%d"/>\n' % ncomp,
        _by_energy('SPECTRUM_SCINT', lam, scint['emission'], per_nm=True)]
    for c in range(ncomp):
        define += [
            _by_energy('ABS_SCINT%d' % c, lam, scint['abslength_mm'][c]),
            _by_energy('REEMIT_SCINT%d' % c, lam,
                       np.full(len(lam), scint['reemission_prob'][c])),
            _matrix('WAVEFORM_SCINT%d' % c,
                    zip(*waveform(scint['reemission_tau_ns'][c])))]
        props += [('ABSLENGTH%d' % c, 'ABS_SCINT%d' % c),
                  ('REEMISSION_PROB%d' % c, 'REEMIT_SCINT%d' % c),
                  ('REEMITWAVEFORM%d' % c, 'WAVEFORM_SCINT%d' % c)]
    material = ['    <material name="scintillator">\n      <D value="%r" '
                'unit="g/cm3"/>\n' % DENSITY]
    material += ['      <fraction n="%r" ref="%s"/>\n' % (f, e)
                 for e, f in ELEMENTS]
    material += ['      <property name="%s" ref="%s"/>\n' % p
                 for p in props]
    material.append('    </material>\n')
    return ''.join(define), ''.join(material)


def snoplus_like_gdml(npmt, path, scint):
    """Write the SNO+-like detector of ``npmt`` PMTs as ``path`` (GDML)
    and its RATDB file (``sno_like_gdml``'s); returns both paths."""
    path, ratdb = sno.sno_like_gdml(npmt, path)
    with open(path) as f:
        text = f.read()
    define, material = scintillator_gdml(scint)
    start = text.index('    <material name="heavy_water">')
    end = text.index('    </material>\n', start) + len('    </material>\n')
    text = text[:start] + material + text[end:]
    for old, new in (('  </define>\n', define + '  </define>\n'),
                     ('<materialref ref="heavy_water"/>',
                      '<materialref ref="scintillator"/>'),
                     ('d2o_', 'scint_')):
        assert text.count(old) >= 1, old
        text = text.replace(old, new)
    with open(path, 'w') as f:
        f.write(text)
    return path, ratdb
