"""Host time a localization-mode frame that the device does not cover: the
program's ``slam.frame`` span less the device's busy time (union) inside
it, in ms, averaged over the frames of kind ``localization``."""

from slambench.measure.stages import host_gap_ms


def read(tw):
    return host_gap_ms(tw, "localization")
