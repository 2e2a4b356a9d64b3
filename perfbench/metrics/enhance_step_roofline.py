"""enhance_step_roofline: the least time the card could take for an
enhanced frame over the time it is busy with one (the profiler's union of
device intervals over the profiled clips' real frames).

The least time is the larger of two terms.  Bytes: the uint8 source frame
in and the uint8 output frame out, 3 bytes a pixel each, at the card's
peak bandwidth.  Operations: Lanczos-4's separable work, 8 taps a sample
and a multiply and an add a tap, for the cheaper order of the two passes,
at the card's float32 peak.  Unsharp and grain are left out of both.
"""

TAPS = 8


def step_bytes(src, dst) -> int:
    return 3 * (src[0] * src[1] + dst[0] * dst[1])


def step_flops(src, dst) -> int:
    (sh, sw), (dh, dw) = src, dst
    height_first = dh * sw + dh * dw
    width_first = sh * dw + dh * dw
    return 2 * TAPS * 3 * min(height_first, width_first)


def read(run):
    trace, peaks = run.trace, run.peaks
    if (trace is None or not trace.frames or peaks is None
            or run.cell.config.get("entry") != "enhance_stream"):
        return None
    least_s = max(step_bytes(run.frame_in, run.frame_out)
                  / peaks["hbm_bytes_per_s"],
                  step_flops(run.frame_in, run.frame_out)
                  / peaks["fp32_flops_per_s"])
    return 100.0 * least_s / (trace.busy_s / trace.frames)
