"""HTTP inference server on the port's classifier.

The HTTP front end and the cross-request micro-batcher are the JAX
package's own (`gava_clip_tpu.server.serve`, stdlib + numpy only); this
module builds the port's `VideoClassifier` (bf16, or w8a8 with
`--quantize w8a8`) and hands it over.

Run: python -m gava_clip_tpu_torch.server --port 8000 [--device cuda]
         [--quantize w8a8 --patch_major]
"""

import argparse

import numpy as np
import torch

from gava_clip_tpu.data.video import parse_classes_file
from gava_clip_tpu.server import serve


def make_server(argv=None):
    """Parse the flags, build and warm up the classifier, and return the
    (not yet serving) HTTP server."""
    from .serve import VideoClassifier
    from .utils.flagship import build_zero_shot

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--classes", default="./classes/k400_classes.txt")
    ap.add_argument("--text_features", default="",
                    help=".npy (n_cls, E) precomputed text features")
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--patch_major", action="store_true",
                    help="ship clips as uint8 patch rows with normalization "
                         "folded into the patch-embed weights")
    ap.add_argument("--quantize", default="", choices=["", "w8a8"],
                    help="w8a8: int8 weights + per-row int8 activations "
                         "(the throughput mode)")
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--device",
                    default="cuda" if torch.cuda.is_available() else "cpu")
    args = ap.parse_args(argv)

    _, labels = parse_classes_file(args.classes)
    tf = np.load(args.text_features) if args.text_features else None
    model = build_zero_shot(num_frames=args.num_frames,
                            num_classes=len(labels), text_features=tf)
    clf = VideoClassifier.from_model(
        model, classnames=labels, batch_size=args.batch_size,
        patch_major=args.patch_major, quantize=args.quantize,
        device=args.device).warmup()
    httpd = serve(clf, args.host, args.port, args.max_wait_ms)
    print(f"serving on {args.host}:{httpd.server_address[1]} "
          f"(batch={args.batch_size}, {args.quantize or 'bf16'}, "
          f"device={args.device})")
    return httpd


def main(argv=None):
    make_server(argv).serve_forever()


if __name__ == "__main__":
    main()
