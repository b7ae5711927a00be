"""The 16-bit stencil probe (K14) of the PyTorch/CUDA port.

The port's counterpart of tools/i16_swar_probe.py: the four stencil bodies
on the TPU probe's (256, 512) planes, through
``cudacam_tpu_torch.probes.i16_swar.swar_stencil`` (kernel in
``cudacam_tpu_torch/csrc/probe_swar.cu``), two 16-bit lanes per 32-bit
register and in the kernel's int32 mode:

  P1  int16 multiply-add chain;   P2  int16 row rolls + adds;
  P3  int16 column rolls with multiplies;
  P4  u8 -> int16 3-row sum -> weighted 3-column sum -> int32.

Prints one OK / MISMATCH line per body (both modes against the plain
version and against the body in int64 with no wrapping) with the
milliseconds of each mode on a card (CUDA events), and a summary line.
``--device cpu`` runs the plain versions and measures nothing;
``--shape HxW`` runs another plane size.

    python3 tools/port_i16_probe.py [--device cpu] [--shape 1080x1920]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(fn, calls: int = 20) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernel) or cpu (plain)")
    ap.add_argument("--shape", default="256x512", help="plane size HxW")
    args = ap.parse_args(argv)
    import torch

    from cudacam_tpu_torch.probes import i16_swar

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the plain versions", file=sys.stderr)
        return 2
    h, w = (int(v) for v in args.shape.lower().split("x"))
    rows = i16_swar.run_probes(args.device, (h, w))
    on_card = torch.device(args.device).type == "cuda"
    xi16, xu8 = (torch.from_numpy(a).to(args.device) for a in i16_swar.probe_inputs(h, w))
    for (name, ok, detail), body in zip(rows, i16_swar.BODIES):
        x = xu8 if body == 4 else xi16
        if on_card:
            t = {swar: _ms(lambda s=swar: i16_swar.swar_stencil(x, body, s)) for swar in (True, False)}
            times = f"swar {t[True]:.6f} ms, int32 {t[False]:.6f} ms ({torch.cuda.get_device_name()})"
        else:
            times = "times not measured (cpu)"
        print(f"{name}: {'OK' if ok else 'MISMATCH'} {detail}; {times}")
    ok = all(r[1] for r in rows)
    print(f"ALL OK at {h}x{w}" if ok else "SOME MISMATCHED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
