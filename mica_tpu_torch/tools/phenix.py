"""PHENIX subprocess wrappers (external suite, kept as subprocess calls).

Counterpart of ``mica_tpu/tools/phenix.py``, the same commands.

Equivalents of the reference's phenix integration: ``real_space_refine``
(modeler.py:2125-2135 + modules/phenix.sh) and ``dock_in_map``
(dock_in_map.py:162-192).  PHENIX is an externally installed suite; these
wrappers build the same command lines and degrade gracefully when the
environment script is absent.
"""

from __future__ import annotations

import logging
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)


DEFAULT_REFINE_PARAMS = str(Path(__file__).parent / "refine_params.eff")


def _phenix_available(phenix_env: str) -> bool:
    return bool(phenix_env) and Path(phenix_env).exists()


def real_space_refine(
    model_path: str,
    map_path: str,
    resolution: float,
    output_dir: str,
    phenix_env: str,
    phenix_param: str = "",
    dry_run: bool = False,
) -> Optional[str]:
    """Run ``phenix.real_space_refine`` in ``output_dir``.

    Returns the command string (also when dry_run / phenix missing).
    """
    model_path = str(Path(model_path).absolute())
    map_path = str(Path(map_path).absolute())
    output_dir = str(Path(output_dir).absolute())
    if not phenix_param:
        phenix_param = DEFAULT_REFINE_PARAMS
    param = str(Path(phenix_param).absolute())
    inner = (
        f"phenix.real_space_refine {model_path} {map_path} {param} "
        f"resolution={resolution}"
    ).replace("  ", " ")
    cmd = f'source {phenix_env} && cd {output_dir} && {inner}'
    if dry_run or not _phenix_available(phenix_env):
        if not dry_run:
            logger.warning("phenix environment not found (%s); skipping refine",
                           phenix_env)
        return cmd
    logger.info("running: %s", inner)
    subprocess.run(["bash", "-c", cmd], stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL, check=False)
    return cmd


def dock_in_map(
    model_path: str,
    map_path: str,
    resolution: float,
    output_path: str,
    phenix_env: str,
    sequence_path: str = "",
    nproc: int = 16,
    dry_run: bool = False,
) -> Optional[str]:
    """Run ``phenix.dock_in_map`` (dock_in_map.py:179-192 command layout)."""
    parts = [
        "phenix.dock_in_map",
        f"search_model={Path(model_path).absolute()}",
        f"map_file={Path(map_path).absolute()}",
        f"nproc={nproc}",
        "quick=False",
        f"resolution={resolution}",
        f"pdb_out={Path(output_path).absolute()}",
        "dock_chains_individually=True",
    ]
    if sequence_path:
        parts.append(f"sequence={Path(sequence_path).absolute()}")
    inner = " ".join(str(p) for p in parts)
    cmd = f"source {phenix_env} && {inner}"
    if dry_run or not _phenix_available(phenix_env):
        if not dry_run:
            logger.warning("phenix environment not found (%s); skipping dock",
                           phenix_env)
        return cmd
    logger.info("running: %s", inner)
    subprocess.run(["bash", "-c", cmd], stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL, check=False)
    return cmd
