"""Kernel D's share of its roofline: the least time an H100 needs for the
bytes and operations of its two launches over a frame's pyramid
(``measure/kernels.py``, from the pyramid's shapes), over the device time
of those two launches in the trace."""

from slambench.measure import kernels as K
from slambench.measure import trace as TR
from slambench.measure.window import kernel_ms


def read(tw):
    fast = kernel_ms(tw, "fast_levels_kernel")
    sel = kernel_ms(tw, "select_levels_kernel")
    if fast is None or sel is None:
        return None
    f = tw.fields
    nbytes, nops = K.detect_work(f["cube_face_w"], f["n_levels"],
                                 f["scale_factor"])
    return 100.0 * TR.bound(nbytes, nops)[0] / ((fast[0] + sel[0]) / fast[1])
