"""Release-notes surface.

A copy of :mod:`vrgdg_tpu.release_notes`: the same file, schema and
errors, held equal to it by ``tests/test_torch_host_copies.py``.

Reads the repo's ``update_notes.json`` using the reference's schema
(``VRGDG_UpdateRoutes.py:65-93``: a JSON object with
``schema_version`` / ``product`` / ``releases`` list, a missing or
malformed ``releases`` degrading to ``[]``). The reference couples this
to git self-update of a ComfyUI checkout — that part stays excluded
(SURVEY.md section 2.5); this module only serves the observability
surface (``/vrgdg/update/status`` and the ``/vrgdg/health`` summary).
"""

from __future__ import annotations

import json
import os

RELEASE_NOTES_FILE = "update_notes.json"

_EMPTY = {"schema_version": 1, "product": "vrgdg_tpu", "releases": []}


def _notes_path() -> str:
    package_dir = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(package_dir), RELEASE_NOTES_FILE)


def load_release_notes(path: str | None = None) -> tuple[dict, str]:
    """``(document, source)`` — source is ``"local"`` when the file was
    read, ``"none"`` when absent. Malformed JSON raises (the reference
    does too); a non-list ``releases`` field is replaced with ``[]``."""
    notes_path = path or _notes_path()
    if not os.path.isfile(notes_path):
        return dict(_EMPTY), "none"
    with open(notes_path, "r", encoding="utf-8") as handle:
        document = json.loads(handle.read())
    if not isinstance(document, dict):
        raise ValueError(f"{RELEASE_NOTES_FILE} must contain a JSON object.")
    if not isinstance(document.get("releases"), list):
        document["releases"] = []
    return document, "local"


def latest_release(document: dict) -> dict | None:
    releases = document.get("releases") or []
    return releases[0] if releases else None
