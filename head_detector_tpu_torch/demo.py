"""Interactive demo (reference ``gradio/app.py:7-33``).

Counterpart of ``head_detector_tpu/demo.py``: a gradio interface over the
five draw modes where gradio is installed, else a CLI that writes the five
renders of one image to disk.

    python -m head_detector_tpu_torch.demo --image IMG [--out-dir DIR]
        [--model vgg_heads_l] [--checkpoint CKPT] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

DRAW_MODES = ("full", "bbox", "landmarks", "points", "pose")


def build_demo(detector=None):
    import gradio as gr

    if detector is None:
        from head_detector_tpu_torch.detector import HeadDetector

        detector = HeadDetector()

    def predict(image: np.ndarray, method: str):
        return detector(image).draw(method)

    return gr.Interface(
        fn=predict,
        inputs=[
            gr.Image(type="numpy", label="Input image"),
            gr.Radio(list(DRAW_MODES), value="full", label="Draw method"),
        ],
        outputs=gr.Image(type="numpy", label="Detections"),
        title="VGGHeads (H100)",
        description="Single-shot 3D head detection + FLAME mesh on the GPU.",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None, help="CLI fallback: render one image")
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--model", default="vgg_heads_l")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from head_detector_tpu_torch.detector import HeadDetector

    detector = HeadDetector(model=args.model, checkpoint=args.checkpoint, device=args.device)

    try:
        import gradio  # noqa: F401
    except ImportError:
        gradio = None
    if gradio is not None:
        build_demo(detector).launch()
        return

    if not args.image:
        raise SystemExit("gradio is not installed; pass --image for the CLI fallback")
    import cv2

    result = detector(args.image)
    os.makedirs(args.out_dir, exist_ok=True)
    for mode in DRAW_MODES:
        cv2.imwrite(os.path.join(args.out_dir, f"{mode}.jpg"),
                    cv2.cvtColor(result.draw(mode), cv2.COLOR_RGB2BGR))
    print(f"wrote {len(DRAW_MODES)} renders to {args.out_dir}; "
          f"{len(result.heads)} heads detected")


if __name__ == "__main__":
    main()
