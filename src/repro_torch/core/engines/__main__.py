"""Engine registry CLI.

    PYTHONPATH=src python -m repro_torch.core.engines --list

``--list`` also prints the engine × config-family support matrix: which
serving path (pooled+fused / mirror+fused / mirror) each KV engine runs
for each model family, sourced from the cache descriptors — so "does int8
pool?" is answered by the registry, not by reading the code.
"""
from __future__ import annotations

import argparse

from repro_torch.core.engines import (get_engine, get_kv_engine,
                                      list_engines, list_kv_engines)


def _print_support_matrix() -> None:
    from repro_torch.core.engines.desc import (MATRIX_FAMILIES,
                                               support_matrix)
    rows = support_matrix()
    fams = [f for f, _, _ in MATRIX_FAMILIES]
    engines = sorted({e for e, _, _ in rows})
    modes = {(e, f): m for e, f, m in rows}
    width = max(max(len(f) for f in fams),
                max(len(m) for m in modes.values())) + 2
    print("\nKV engine x config family (cache-descriptor support matrix):")
    print("  " + " " * 10 + "".join(f"{f:>{width}}" for f in fams))
    for eng in engines:
        cells = "".join(f"{modes[(eng, f)]:>{width}}" for f in fams)
        print(f"  {eng:10s}{cells}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.core.engines",
        description="inspect the cache-engine registries (FS + KV tiers)")
    ap.add_argument("--list", action="store_true",
                    help="list registered engines and the per-family "
                         "serving-path support matrix (the default and "
                         "only action)")
    ap.parse_args(argv)      # listing is the only mode; this rejects typos
    for name in list_engines():
        cls = get_engine(name)
        # a docstring-less plugin class has __doc__ = None (not inherited)
        doc = next(iter((cls.__doc__ or "").strip().splitlines()), "")
        nvmm = "nvmm" if cls.uses_nvmm else "lpc "
        print(f"{name:12s} [{nvmm}] {doc}")
    for name in list_kv_engines():
        cls = get_kv_engine(name)
        doc = next(iter((cls.__doc__ or "").strip().splitlines()), "")
        print(f"{name:12s} [kv  ] {doc}")
    _print_support_matrix()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
