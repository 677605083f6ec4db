"""Clip tooling CLI: decrypt event clips, inspect GGUF/safetensors files.

Usage:
    python -m clearcam_tpu.tools.clip_cli decrypt clip.mp4.aes out.mp4 --key K
    python -m clearcam_tpu.tools.clip_cli inspect model.gguf
    python -m clearcam_tpu.tools.clip_cli inspect weights.safetensors
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decrypt", help="decrypt a .aes event clip")
    d.add_argument("src")
    d.add_argument("dst")
    d.add_argument("--key", required=True)
    i = sub.add_parser("inspect", help="list tensors/metadata of a model file")
    i.add_argument("path")
    args = ap.parse_args(argv)

    if args.cmd == "decrypt":
        from ..cloud.crypto import decrypt_file
        ok = decrypt_file(Path(args.src), Path(args.dst), args.key)
        print("ok" if ok else "FAILED")
        raise SystemExit(0 if ok else 1)

    path = Path(args.path)
    if path.suffix == ".gguf":
        from ..io import gguf
        kv, tensors = gguf.load(path)
        print(f"arch: {kv.get('general.architecture')}")
        for k, v in sorted(kv.items()):
            if not k.startswith("tokenizer."):
                print(f"  {k} = {v if not isinstance(v, list) or len(v) < 8 else f'[{len(v)} items]'}")
        print(f"{len(tensors)} tensors:")
        for name, arr in list(tensors.items())[:50]:
            print(f"  {name}: {arr.shape} {arr.dtype}")
        if len(tensors) > 50:
            print(f"  ... +{len(tensors) - 50} more")
    else:
        from ..io import safetensors as st
        hdr = st.read_header(path)
        for name, info in list(hdr.items())[:80]:
            if name != "__metadata__":
                print(f"  {name}: {info['shape']} {info['dtype']}")
        print(f"{len(hdr)} tensors")


if __name__ == "__main__":
    main()
