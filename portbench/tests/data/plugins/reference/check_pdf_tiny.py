"""A test's new check: the share of channels whose PDF evaluation is
not a finite probability density with a count of its own."""
import numpy as np


def compare(ref, samples, device):
    bad = total = 0
    for hitcount, pdf, unc in samples:
        ok = np.isfinite(pdf) & (pdf >= 0) & (hitcount >= 0) \
            & np.isfinite(unc)
        bad += int((~ok).sum())
        total += len(ok)
    return dict(pdf_bad=bad / total if total else 1.0,
                counts=dict(channels=total))
