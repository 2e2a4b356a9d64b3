"""lut_ms_per_frame: the device time of the window's ``grade.lut`` spans
(the eager LUT stage of ``ops.grade.grade_prepared``), read from the
CUDA events each span records on the card, over the real frames the
window's spans count (Σ ``frames`` of ``batch.enqueue`` less Σ
``pad_frames`` of ``batch.pad``, as ``perfbench/spans.py`` counts them).
Nothing without a ``grade.lut`` span that carries events: a program whose
spans time no stage on the device gives no reading."""

from perfbench.spans import window_spans


def read(run):
    records = window_spans(run)
    if records is None:
        return None
    try:
        from vrgdg_tpu_torch.runtime.profiling import device_ms
    except ImportError:
        return None
    frames = pad = 0
    total_ms, spans = 0.0, 0
    for record in records:
        if record.name == "batch.enqueue":
            frames += record.counts.get("frames", 0)
        elif record.name == "batch.pad":
            pad += record.counts.get("pad_frames", 0)
        elif record.name == "grade.lut" and record.events is not None:
            total_ms += device_ms(record)
            spans += 1
    if not spans or frames - pad <= 0:
        return None
    return total_ms / (frames - pad)
