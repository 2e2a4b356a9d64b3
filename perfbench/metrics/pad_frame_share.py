"""pad_frame_share: the share of the frames the device ran that were tail
padding: the pad_frames of the window's batch.pad spans over the frames of
its batch.enqueue spans (the program's own counts, perfbench/spans.py)."""

from perfbench.spans import window_spans


def read(run):
    records = window_spans(run)
    if records is None:
        return None
    frames = sum(r.counts.get("frames", 0) for r in records
                 if r.name == "batch.enqueue")
    pad = sum(r.counts.get("pad_frames", 0) for r in records
              if r.name == "batch.pad")
    return 100.0 * pad / frames if frames else None
