"""speedy_wave-equivalent CLI of the PyTorch port (port of speedy_tpu/cli.py,
grid engine).

Usage:
  python -m speedy_tpu_torch.cli --input sound.wav --output fast.wav \\
      --engine grid [--speed 3.0] [--nonlinear 1.0 | --linear]
      [--match_nonlinear] [--length SECONDS]
      [--duration_feedback_strength 0.1] [--device cuda]

The flags are speedy_wave.cc:257-277's, as in the JAX package's CLI:
  --match_nonlinear : run speedy once to measure the achieved rate, then
    compress at that measured overall speed (speedy_wave.cc:424-427);
  --length          : two-pass targeting of a total output duration
    (speedy_wave.cc:428-462).
--device names the torch device (default cuda; without a card that is an
error, not a CPU run). Only --engine grid is ported. The JAX CLI runs the
streaming shim for the other engines, for --rate, for the dump files and
for multichannel input; here each of them is an error that names the
ROADMAP item porting it.
"""

from __future__ import annotations

import argparse
import sys

from .config import SpeedyConfig
from .io.wave import read_wave, write_wave
from .ops.kernels import resolve_device
from .pipeline import check_engine, nonlinear_speedup

_STREAMING = 'ROADMAP.md queue A, "Streaming"'


def check_supported(engine: str, rate: float, dump_files: dict, num_channels: int = 1):
    """Raise NotImplementedError for what the port's CLI does not run yet."""
    check_engine(engine)
    if rate != 1.0:
        raise NotImplementedError(f"--rate is not ported yet; {_STREAMING} ports it")
    if any(dump_files.values()):
        raise NotImplementedError(
            f"the dump files (--tension_file etc.) are not ported yet; {_STREAMING} "
            "ports them"
        )
    if num_channels > 1:
        raise NotImplementedError(
            'multichannel input is not ported yet; ROADMAP.md queue A, '
            '"batched_nonlinear_speedup_multichannel" ports it'
        )


def compress_sound(
    input_file: str,
    speed: float,
    nonlinear: float,
    feedback: float,
    output_file: str = "",
    rate: float = 1.0,
    engine: str = "stream",
    dump_files: dict | None = None,
    *,
    device="cuda",
) -> float:
    """Read a WAV, speed it up on `device` (the card by default; without
    one that raises), optionally write the result;
    return the achieved compression ratio (input frames / output frames)
    like speedy_wave.cc's compress_sound (speedy_wave.cc:154-242)."""
    device = resolve_device(device)
    samples, sr = read_wave(input_file)
    num_channels = 1 if samples.ndim == 1 else samples.shape[1]
    check_supported(engine, rate, dump_files or {}, num_channels)
    out = nonlinear_speedup(
        samples, SpeedyConfig(sr), speed, nonlinear, feedback, engine=engine,
        device=device,
    ).output
    if output_file:
        write_wave(output_file, out, sr)
    return len(samples) / max(len(out), 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="speedy_wave",
        description="Nonlinear (Mach1/Speedy) speech speedup of a WAV file.",
    )
    ap.add_argument("--input", "-i", required=True)
    ap.add_argument("--output", "-o", required=True)
    ap.add_argument("--speed", "-s", type=float, default=3.0)
    ap.add_argument("--nonlinear", "-n", type=float, default=1.0,
                    help="0 = linear; 1 = full speedy nonlinear speedup")
    ap.add_argument("--linear", "-l", action="store_true",
                    help="force linear speedup (nonlinear = 0)")
    ap.add_argument("--match_nonlinear", action="store_true",
                    help="measure the nonlinear achieved rate, then compress "
                         "at that overall speed")
    ap.add_argument("--length", "-e", type=float, default=0.0,
                    help="desired output length in seconds (two-pass)")
    ap.add_argument("--duration_feedback_strength", "-d", type=float, default=0.1)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="varispeed playback rate (sonicSetRate); not ported")
    ap.add_argument("--tension_file", "-t", default="")
    ap.add_argument("--speed_file", "-p", default="")
    ap.add_argument("--features_file", "-f", default="")
    ap.add_argument("--spectrogram_file", "-S", default="")
    ap.add_argument("--normalized_spectrogram_file", "-N", default="")
    ap.add_argument("--engine", choices=("stream", "scan", "grid", "device-stream"),
                    default="stream", help="only grid is ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    speed = args.speed
    nonlinear = 0.0 if args.linear else args.nonlinear
    fb = args.duration_feedback_strength
    dumps = {
        "tension": args.tension_file,
        "speed": args.speed_file,
        "features": args.features_file,
        "spectrogram": args.spectrogram_file,
        "normalized_spectrogram": args.normalized_spectrogram_file,
    }
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device: {e}")

    def run(speed, nonlinear, output="", rate=1.0, dump_files=None):
        return compress_sound(
            args.input, speed, nonlinear, fb, output, rate, args.engine, dump_files,
            device=device,
        )

    try:
        # Refuse what is not ported before any pass runs.
        check_supported(args.engine, args.rate, dumps)
        if args.match_nonlinear:
            # speedy_wave.cc:424-427: measure the nonlinear achieved rate.
            speed = run(speed, 1.0)
            print(f"Nonlinear run achieved {speed:.4f}x; matching it.")
        elif args.length > 0:
            # speedy_wave.cc:428-462: two-pass length targeting.
            samples, sr = read_wave(args.input)
            desired_speed = (len(samples) / sr) / args.length
            achieved = run(desired_speed, 1.0)
            speed = desired_speed * (desired_speed / achieved)
            print(
                f"Targeting {args.length}s: first pass at {desired_speed:.4f}x "
                f"achieved {achieved:.4f}x; using {speed:.4f}x."
            )
        kind = "non-linearly" if nonlinear > 0 else "linearly"
        print(f"Reading {args.input}, speeding up {kind} by {speed}x into {args.output}.")
        achieved = run(speed, nonlinear, args.output, args.rate, dumps)
    except NotImplementedError as e:
        ap.error(str(e))
    print(f"Achieved overall compression: {achieved:.4f}x.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
