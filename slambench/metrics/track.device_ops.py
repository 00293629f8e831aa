"""Device operations of a frame that only tracked, averaged over such
frames (see ``track.busy_ms``)."""

from slambench.measure.window import plain_frame


def read(tw):
    frames = tw.frame_ops(plain_frame)
    if not frames:
        return None
    return sum(len(ops) for ops in frames) / len(frames)
