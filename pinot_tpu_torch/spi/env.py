"""Environment-layered configuration.

Copy of pinot_tpu/spi/env.py (host-only): the same variables layer the
options of both packages.

Reference parity: Pinot's config layering (properties files overridden by
env/system properties — PinotConfiguration's precedence chain).  Here the
layers, weakest first, are:

  1. engine defaults (QueryContext option defaults)
  2. process environment: PINOT_TPU_OPT_<optionName>=<value>
  3. per-query `OPTION(...)` / `SET k = v;` in the SQL text

so e.g. `PINOT_TPU_OPT_numGroupsLimit=50000` caps every query in the
process unless the query sets its own value.  Values parse as JSON when
possible (numbers/bools), else stay strings.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

_PREFIX = "PINOT_TPU_OPT_"


def env_options(environ: Dict[str, str] = None) -> Dict[str, Any]:
    env = os.environ if environ is None else environ
    out: Dict[str, Any] = {}
    for k, v in env.items():
        if not k.startswith(_PREFIX):
            continue
        name = k[len(_PREFIX) :]
        try:
            out[name] = json.loads(v)
        except (json.JSONDecodeError, ValueError):
            out[name] = v
    return out


def apply_env_defaults(options: Dict[str, Any], environ: Dict[str, str] = None) -> None:
    """Overlay env-provided option defaults UNDER the query's own options."""
    for k, v in env_options(environ).items():
        options.setdefault(k, v)
