"""EMDB metadata retrieval (contour level + resolution).

The port's own copy of ``mica_tpu/prep/emdb.py``: queries the EMDB REST API
for an entry's recommended contour level and reported resolution.  Without
the network, or without ``requests``, it returns None.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

EMDB_API = "https://www.ebi.ac.uk/emdb/api/entry/{emdb_id}"


def extract_map_info(emdb_id: str, timeout: float = 10.0) -> Optional[Tuple[float, float]]:
    """EMDB id (e.g. '15635' or 'EMD-15635') -> (contour_level, resolution)."""
    emdb_id = emdb_id.upper().replace("EMD-", "").strip()
    try:
        import requests

        r = requests.get(EMDB_API.format(emdb_id=emdb_id), timeout=timeout)
        r.raise_for_status()
        data = r.json()
        contour = None
        resolution = None
        try:
            contour = float(
                data["map"]["contour_list"]["contour"][0]["level"]
            )
        except (KeyError, IndexError, TypeError, ValueError):
            pass
        try:
            resolution = float(
                data["structure_determination_list"]["structure_determination"][0]
                ["image_processing"][0]["final_reconstruction"]["resolution"]["valueOf_"]
            )
        except (KeyError, IndexError, TypeError, ValueError):
            try:
                resolution = float(
                    data["structure_determination_list"]["structure_determination"][0]
                    ["image_processing"][0]["final_reconstruction"]["resolution"]
                )
            except Exception:
                pass
        return contour, resolution
    except Exception as e:
        logger.warning("EMDB lookup failed for %s: %s", emdb_id, e)
        return None
