"""``--set`` config overrides for the port's command-line entry points.

Port of ``vit_marl_tpu/utils/cli.py``: repeated ``--set KEY=VALUE`` flags
are merged into the raw YAML dict before ``make_config``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import yaml


def apply_set_overrides(raw: Dict, sets: List[str]) -> Dict:
    """Merge ``KEY=VALUE`` / ``A.B.C=VALUE`` overrides into ``raw`` in place.

    - Values parse as numbers first (plain scientific notation such as
      ``1e6`` is a number here, where YAML 1.1 reads it as a string), then
      as YAML scalars (true/false/strings).  ``inf`` and ``nan`` are
      refused: no config value takes them.
    - Dotted keys reach nested sections; each segment matches an existing
      key without regard to case, so ``EXECUTION.TASK_SIZE`` merges into
      the file's ``Execution`` section.  A missing section is created
      upper-case.  ``make_config`` stays strict: unknown keys raise there.
    """
    for kv in sets:
        if "=" not in kv:
            raise ValueError(f"--set expects KEY=VALUE, got {kv!r}")
        key, val = kv.split("=", 1)
        try:
            num = float(val)
        except ValueError:
            parsed = yaml.safe_load(val)
        else:
            if not math.isfinite(num):
                raise ValueError(f"--set {kv!r}: inf and nan are not "
                                 "accepted")
            parsed = (int(num) if num == int(num) and "." not in val
                      and "e" not in val.lower() else num)
        parts = key.split(".")
        node = raw
        for p in parts[:-1]:
            match = next((k for k in node if k.lower() == p.lower()), None)
            if match is None or not isinstance(node[match], dict):
                match = p.upper()
                node[match] = {}
            node = node[match]
        last = next((k for k in node if k.lower() == parts[-1].lower()),
                    parts[-1].upper())
        node[last] = parsed
    return raw
