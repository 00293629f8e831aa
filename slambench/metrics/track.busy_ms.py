"""Device busy ms of a frame that only tracked (its row shows no
keyframe, no deferred BA, no loop closure): the union of the device
intervals of what its span launched, averaged over such frames."""

from slambench.measure.window import busy_ms, plain_frame


def read(tw):
    frames = tw.frame_ops(plain_frame)
    if not frames:
        return None
    return sum(busy_ms(ops) for ops in frames) / len(frames)
