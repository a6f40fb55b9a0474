"""Per-op collective breakdown for one dry-run cell (port of
`repro.launch.diagnose`): the cell's step traced on fake tensors over the
fake (16, 16) world, and its largest collectives by bytes times count,
each named by the module path that issued it
(`torch.utils.module_tracker.ModuleTracker`, the counterpart of the HLO
`op_name` metadata) and the port's function.

    python -m repro_torch.launch.diagnose --arch phi4-mini-3.8b \\
        --shape decode_32k [--top 15] [--multi-pod]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import count_cell, fake_device
from repro_torch.launch.mesh import make_production_mesh


def top_collectives(arch: str, shape: str, top: int = 15,
                    multi_pod: bool = False) -> tuple[float, list]:
    """-> (collective bytes a device, [(bytes x count, bytes, count, type,
    issued by)] of the `top` largest)."""
    from torch.utils.module_tracker import ModuleTracker
    mesh = make_production_mesh(multi_pod=multi_pod, fake=True,
                                device=fake_device())
    with ModuleTracker() as tracker:
        res = count_cell(get_config(arch), shape, mesh, tracker=tracker)
    return res["collective_bytes"], res["top_collectives"][:top]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    total, rows = top_collectives(args.arch, args.shape, args.top,
                                  args.multi_pod)
    print(f"total collective bytes/dev: {total/1e9:.2f} GB")
    for tb, b, m, op, name in rows:
        print(f"{tb/1e9:9.3f} GB  ({b/1e6:8.1f} MB x{m:4d})  {op:20s} "
              f"{name[:110]}")


if __name__ == "__main__":
    main()
