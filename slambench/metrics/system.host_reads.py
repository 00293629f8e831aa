"""Host reads a localization-mode frame, as the program counts them: the
mean ``host_reads`` of the rows of kind ``localization`` (the counter
behind ``system.host_waits``)."""

from slambench.measure.stages import kind_frames


def read(tw):
    frames = kind_frames(tw, "localization")
    if not frames:
        return None
    return sum(tw.rows[i]["host_reads"] for i in frames) / len(frames)
