"""Command-line interface of the port: the headless engine front door.

A copy of viamd_tpu/app/cli.py over the port's Session: the same
subcommands, flags and exit codes, and one more flag on each subcommand,
`--device` (default `cuda`), the torch device the session computes on
(`--device cpu` runs on the host). Images are copied to the host only to
be encoded.

The reference has no CLI flags ("Currently we do not support any command
line flags", VIAMD src/main.cpp:535-537) — argv is files only.
The headless north star requires a real one (SURVEY.md §5.6):

  viamd-tpu-torch info FILE...                system summary
  viamd-tpu-torch eval FILE... -s SCRIPT [-o out.csv] [--xvg] [--frames A:B]
  viamd-tpu-torch render FILE... [-o out.png] [--rep TYPE] [--color MAPPING]
  viamd-tpu-torch movie FILE... [-o pat_%04d.png] [--frames A:B] [--motion-blur]
  viamd-tpu-torch volume FILE... -s SCRIPT -p PROP [-o out.png] [--cube out.cube]
  viamd-tpu-torch view FILE... [--port 8844]  interactive browser viewer
  viamd-tpu-torch transcode TRAJ -o out.vtraj packed cache
  viamd-tpu-torch workspace FILE.via [--render out.png] [--eval]
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_session(files, device):
    from viamd_tpu_torch.app.session import Session

    s = Session(device=device)
    for f in files:
        if f == "demo":
            # built-in demo dataset + the reference's default script
            # (main.cpp:513-530): `viamd-tpu-torch eval demo`, `render demo`, …
            s.load_demo()
        else:
            s.load(f)
    return s


def _frame_range(spec: str | None, total: int):
    if not spec:
        return None
    beg, _, end = spec.partition(":")
    return range(int(beg or 0), int(end or total))


def cmd_info(args):
    s = _load_session(args.files, args.device)
    print(json.dumps(s.components["dataset"].summary(), indent=2))
    return 0


def cmd_eval(args):
    s = _load_session(args.files, args.device)
    # batch context: stage frames to HBM so evaluation runs the fused
    # one-dispatch chunk path (Session.stage_to_device docstring)
    s.stage_to_device()
    script = (
        open(args.script_file).read() if args.script_file else args.script
    )
    if script or not s.script_text:
        s.set_script(script)
    elif s.compiled is None:
        s.compile_script()  # keep a script injected by the loaded files
    if s.script_errors:
        print("script error:", s.script_errors[0], file=sys.stderr)
        return 1
    res = s.evaluate(
        frame_range=_frame_range(args.frames, s.num_frames),
        progress=(lambda f: print(f"\r{f * 100:.0f}%", end="", file=sys.stderr))
        if not args.quiet
        else None,
    )
    if not args.quiet:
        print(file=sys.stderr)
    from viamd_tpu_torch.app import export as ex

    out = args.output or "-"
    buf = sys.stdout if out == "-" else None
    for p in res.properties:
        if p.kind == "distribution":
            dist_path = out.replace(".csv", f".{p.name}.csv") if buf is None else buf
            vol = s.system.cell.volume() if s.system.cell.is_periodic else 0.0
            ex.export_distribution_csv(res, dist_path, p.name, volume=vol)
    temporal = [p for p in res.properties if p.kind == "temporal"]
    if temporal:
        if args.xvg:
            ex.export_temporal_xvg(res, buf or out)
        else:
            ex.export_temporal_csv(res, buf or out)
    return 0


def cmd_render(args):
    s = _load_session(args.files, args.device)
    s.representations[0].type = args.rep
    s.representations[0].color_mapping = args.color
    if args.filter:
        s.representations[0].filter = args.filter
    s._update_representations()
    if args.frame is not None:
        s.set_frame(args.frame)
    img, depth, _pick = s.render(
        args.width, args.height, postprocess=args.postprocess
    )
    from viamd_tpu_torch.app.export import save_image

    save_image(args.output, img.cpu().numpy())
    print(f"wrote {args.output}")
    return 0


def cmd_volume(args):
    s = _load_session(args.files, args.device)
    script = (
        open(args.script_file).read() if args.script_file else args.script
    )
    if script or not s.script_text:
        s.set_script(script)
    res = s.evaluate()
    dv = s.components["density_volume"]
    if args.iso:
        dv.set_isosurfaces([float(v) for v in args.iso.split(",")])
    names = dv.volume_properties()
    prop = args.prop or (names[0] if names else None)
    if prop is None:
        print("no volume properties in script", file=sys.stderr)
        return 1
    if args.cube:
        from viamd_tpu_torch.app.export import export_cube

        meta = res.property(prop)
        grid = res.normalized_volume(prop)
        ext = meta.spec.extent
        vox = 2 * ext / meta.spec.dims
        export_cube(
            args.cube, grid, origin=[-ext] * 3, voxel=[vox] * 3
        )
        print(f"wrote {args.cube}")
    if args.output:
        img, _ = dv.render(prop, args.width, args.height)
        from viamd_tpu_torch.app.export import save_image

        save_image(args.output, img.cpu().numpy())
        print(f"wrote {args.output}")
    return 0


def cmd_movie(args):
    try:
        args.output % 0
    except (TypeError, ValueError):
        raise ValueError(
            f"output pattern {args.output!r} needs a frame-number specifier "
            "(e.g. frame_%04d.png)"
        )
    s = _load_session(args.files, args.device)
    s.representations[0].type = args.rep
    s._update_representations()
    if args.frames:
        beg, _, end = args.frames.partition(":")
        fr = range(int(beg or 0), int(end or s.num_frames), args.step)
    else:
        fr = range(0, max(s.num_frames, 1), args.step)
    from viamd_tpu_torch.app.export import save_image

    n = 0
    for f, rgba in s.render_frames(
        fr, args.width, args.height, motion_blur=args.motion_blur,
        taa=args.taa, postprocess=args.postprocess,
        progress=(
            None if args.quiet
            else lambda p: print(f"\r{p*100:.0f}%", end="", file=sys.stderr)
        ),
    ):
        save_image(args.output % n, rgba.cpu().numpy())
        n += 1
    if not args.quiet:
        print(file=sys.stderr)
    if n:
        print(f"wrote {n} frames ({args.output % 0} … {args.output % (n - 1)})")
    else:
        print("wrote 0 frames")
    return 0


def cmd_view(args):
    s = _load_session(args.files, args.device)
    if args.rep:
        s.representations[0].type = args.rep
        s._update_representations()
    from viamd_tpu_torch.app.viewer import ViewerServer

    ViewerServer(s, host=args.host, port=args.port).serve()
    return 0


def cmd_transcode(args):
    from viamd_tpu_torch.io import load_file
    from viamd_tpu_torch.io.cache import transcode

    res = load_file(args.file)
    if res.trajectory is None:
        print("not a trajectory file", file=sys.stderr)
        return 1
    transcode(res.trajectory, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_workspace(args):
    from viamd_tpu_torch.app.session import Session

    s = Session(device=args.device)
    s.load_workspace(args.file)
    if args.eval and s.script_text:
        s.evaluate()
    if args.render:
        img, _, _ = s.render(args.width, args.height)
        from viamd_tpu_torch.app.export import save_image

        save_image(args.render, img.cpu().numpy())
        print(f"wrote {args.render}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="viamd-tpu-torch",
        description="molecular visual-analysis engine (PyTorch/CUDA port)",
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device to compute on (default cuda)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", parents=[common], help="system summary")
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("eval", parents=[common], help="evaluate an analysis script")
    p.add_argument("files", nargs="+")
    p.add_argument("-s", "--script", default="")
    p.add_argument("-S", "--script-file")
    p.add_argument("-o", "--output")
    p.add_argument("--xvg", action="store_true")
    p.add_argument("--frames", help="A:B frame window")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("render", parents=[common], help="render molecules to an image")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--rep", default="spacefill",
                   choices=["spacefill", "licorice", "ballstick"])
    p.add_argument("--color", default="cpk")
    p.add_argument("--filter")
    p.add_argument("--frame", type=float)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--postprocess", action="store_true",
                   help="full quality chain: HBAO, tonemap, FXAA 3.11")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("volume", parents=[common], help="render/export a volume property")
    p.add_argument("files", nargs="+")
    p.add_argument("-s", "--script", default="")
    p.add_argument("-S", "--script-file")
    p.add_argument("-p", "--prop")
    p.add_argument("-o", "--output")
    p.add_argument("--cube")
    p.add_argument("--iso", help="comma-separated relative iso values")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.set_defaults(fn=cmd_volume)

    p = sub.add_parser("movie", parents=[common], help="render a frame range to numbered PNGs")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--output", default="frame_%04d.png",
                   help="printf-style pattern, e.g. out/f_%%04d.png")
    p.add_argument("--rep", default="spacefill",
                   choices=["spacefill", "licorice", "ballstick"])
    p.add_argument("--frames", help="A:B frame window")
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument("--taa", action="store_true",
                   help="velocity-reprojected temporal AA across frames "
                        "(temporal.frag resolve; stable under camera motion)")
    p.add_argument("--postprocess", action="store_true",
                   help="full quality chain: HBAO, tonemap, FXAA 3.11")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=cmd_movie)

    p = sub.add_parser("view", parents=[common], help="interactive browser viewer")
    p.add_argument("files", nargs="+")
    p.add_argument("--rep", default="", help="initial representation type")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8844)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("transcode", parents=[common], help="pack a trajectory into .vtraj")
    p.add_argument("file")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_transcode)

    p = sub.add_parser("workspace", parents=[common], help="load a .via workspace")
    p.add_argument("file")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--render")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.set_defaults(fn=cmd_workspace)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # stdout consumer (e.g. `head`) closed early
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
