"""The hysteresis-construct probes (K13) of the PyTorch/CUDA port.

The port's counterpart of tools/hyster_kernel_probe.py: each risky
construct of the round kernels alone, on the TPU probe's planes, through
``cudacam_tpu_torch.probes.hyster_kernel`` (kernels in
``cudacam_tpu_torch/csrc/probe_hyster.cu``):

  A   pack of a (128, 256) u8 mask through a shared-memory tile transpose;
  A'  the same pack with no shared memory, one __ballot_sync a word, warp
      tasks of one word row x 32 columns over the whole card;
  B/C/D  a round loop ended by a device "changed" flag (rolls on both axes,
      a shift inside each word), from one set bit of a (40, 256) plane: the
      plane resident in one block's registers with one __syncthreads_or a
      round (a cooperative grid with a scratch plane and a grid.sync() a
      round for planes it does not hold);
  E   unpack of (4, 256) words to u8, a thread per word and per byte.

Prints one OK / MISMATCH line per probe and a summary line. On a card
(the default, ``--device cuda``) it runs the kernels and, with
``--sync-table``, prints the microseconds of one grid.sync() against the
grid size; ``--device cpu`` runs the plain versions.

    python3 tools/port_kernel_probe.py [--device cpu] [--sync-table]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain)")
    ap.add_argument("--sync-table", action="store_true",
                    help="also time one grid.sync() against the grid size (a card only)")
    args = ap.parse_args(argv)
    import torch

    from cudacam_tpu_torch.probes import hyster_kernel

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the plain versions", file=sys.stderr)
        return 2
    rows = hyster_kernel.run_probes(args.device)
    for name, ok, detail in rows:
        print(f"{name}: {'OK' if ok else 'MISMATCH'}" + (f" {detail}" if detail else ""))
    if args.sync_table:
        for blocks, us in hyster_kernel.grid_sync_us(args.device):
            print(f"grid.sync() at {blocks} blocks: {us:.3f} us ({torch.cuda.get_device_name()})")
    ok = all(r[1] for r in rows)
    print("ALL OK" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
