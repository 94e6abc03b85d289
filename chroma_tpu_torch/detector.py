"""Detector: a Geometry whose solids can be photon-detecting channels.

(parity: chroma/detector.py — PMT channel maps + shared time/charge CDFs)
"""
import numpy as np

from chroma_tpu_torch.geometry import Geometry


class Detector(Geometry):
    """A Geometry that maps some solids to electronics channels ("PMTs").

    Channel *indices* are dense 0..n-1; channel *types* are arbitrary
    stable integers chosen by the user.  All channels currently share
    one transit-time CDF and one single-photoelectron charge CDF
    (reference: chroma/detector.py:5).
    """

    def __init__(self, detector_material=None):
        Geometry.__init__(self, detector_material=detector_material)

        self.solid_id_to_channel_index = []
        self.channel_index_to_solid_id = []
        self.channel_index_to_channel_type = []
        self.channel_index_to_position = []

        # delta-function time and unit-charge defaults
        self.time_cdf = (np.array([-1e-8, 1e-8]), np.array([0.0, 1.0]))
        self.charge_cdf = (np.array([0.999999999, 1.0]), np.array([0.0, 1.0]))

    def add_solid(self, solid, rotation=None, displacement=None):
        solid_id = Geometry.add_solid(self, solid=solid, rotation=rotation,
                                      displacement=displacement)
        self.solid_id_to_channel_index.append(-1)  # not a channel
        return solid_id

    def add_pmt(self, pmt, rotation=None, displacement=None,
                channel_type=None):
        """Place ``pmt`` and register it as the next electronics channel.

        Returns {'solid_id', 'channel_index', 'channel_type'}.
        """
        solid_id = self.add_solid(solid=pmt, rotation=rotation,
                                  displacement=displacement)
        channel_index = len(self.channel_index_to_solid_id)
        if channel_type is None:
            channel_type = channel_index

        self.solid_id_to_channel_index[solid_id] = channel_index
        self.channel_index_to_solid_id.append(solid_id)
        self.channel_index_to_channel_type.append(channel_type)
        self.channel_index_to_position.append(
            np.zeros(3) if displacement is None else displacement)
        return {'solid_id': solid_id,
                'channel_index': channel_index,
                'channel_type': channel_type}

    @staticmethod
    def _pdf_to_cdf(bin_edges, bin_contents):
        """(cdf_x, cdf_y) for a binned PDF; contents NOT width-normalized."""
        cdf_x = np.copy(bin_edges)
        cdf_y = np.concatenate([[0.0], np.cumsum(bin_contents)])
        cdf_y /= cdf_y[-1]
        return (cdf_x, cdf_y)

    def set_time_dist_gaussian(self, rms, lo, hi, nsamples=50):
        pdf_x = np.linspace(lo, hi, nsamples + 1, endpoint=True)
        pdf_y = np.exp(-0.5 * (pdf_x[1:] / rms) ** 2)
        self.time_cdf = self._pdf_to_cdf(pdf_x, pdf_y)

    def set_time_dist(self, bin_edges, bin_contents):
        self.time_cdf = self._pdf_to_cdf(bin_edges, bin_contents)

    def set_charge_dist_gaussian(self, mean, rms, lo, hi, nsamples=50):
        pdf_x = np.linspace(lo, hi, nsamples + 1, endpoint=True)
        pdf_y = np.exp(-0.5 * ((pdf_x[1:] - mean) / rms) ** 2)
        self.charge_cdf = self._pdf_to_cdf(pdf_x, pdf_y)

    def set_charge_dist(self, bin_edges, bin_contents):
        self.charge_cdf = self._pdf_to_cdf(bin_edges, bin_contents)

    def num_channels(self):
        return len(self.channel_index_to_channel_type)

    def flatten(self):
        self.solid_id_to_channel_index = np.asarray(
            self.solid_id_to_channel_index, dtype=np.int32)
        self.channel_index_to_solid_id = np.asarray(
            self.channel_index_to_solid_id, dtype=np.int32)
        self.channel_index_to_channel_type = np.asarray(
            self.channel_index_to_channel_type, dtype=np.int32)
        self.channel_index_to_position = np.asarray(
            self.channel_index_to_position, dtype=np.float32)
        Geometry.flatten(self)
