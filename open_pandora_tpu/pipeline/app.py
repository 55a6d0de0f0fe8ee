"""Gradio web app — the reference's UI layer (gradio_app.py).

The reference serves a Blocks app on port 10041 with 5 per-round Action
buttons, a Multi-Action batch button, and sliders for fps/n_samples/
guidance/steps/eta/rounds (gradio_app.py:35-84,200-212). This module
reproduces that surface when gradio is installed (it is not in this image —
the CLI `open_pandora_tpu.pipeline.cli` covers the same functionality
headless).
"""

from __future__ import annotations

import argparse
import sys


def build_app(chat):
    import gradio as gr

    with gr.Blocks(title="Open-Pandora") as demo:
        gr.Markdown("# Open-Pandora — interactive world model")
        with gr.Row():
            image_in = gr.Image(type="pil", label="Conditioning image")
            video_out = gr.Video(label="Generated video")
        with gr.Row():
            fs = gr.Slider(1, 30, value=15, step=1, label="FS")
            ugs = gr.Slider(1.0, 15.0, value=4.0, step=0.5,
                            label="Guidance scale")
            steps = gr.Slider(1, 60, value=50, step=1, label="DDIM steps")
            eta = gr.Slider(0.0, 1.0, value=1.0, step=0.1, label="DDIM eta")
            seed = gr.Number(value=123, label="Seed", precision=0)
        actions = [gr.Textbox(label=f"Action round {i+1}") for i in range(5)]

        def run_round(i):
            def fn(img, text, fs, ugs, steps, eta, seed):
                kw = dict(ddim_steps=int(steps), fs=int(fs),
                          guidance_scale=float(ugs), eta=float(eta),
                          seed=int(seed))
                if i == 0:
                    chat.generate_video(img, text, **kw)
                else:
                    chat.generate_video_next_round(text, **kw)
                return chat.save_video(f"/tmp/pandora_round{i}.mp4")
            return fn

        for i, a in enumerate(actions):
            btn = gr.Button(f"Generate round {i+1}")
            btn.click(run_round(i),
                      inputs=[image_in, a, fs, ugs, steps, eta, seed],
                      outputs=[video_out])

        multi = gr.Button("Multi-Action (all rounds)")

        def run_multi(img, *args_):
            texts = [t for t in args_[:5] if t]
            fs_, ugs_, steps_, eta_, seed_ = args_[5:]
            chat.generate_video_multiround(
                img, texts, ddim_steps=int(steps_), fs=int(fs_),
                guidance_scale=float(ugs_), eta=float(eta_), seed=int(seed_))
            return chat.save_video("/tmp/pandora_multi.mp4")

        multi.click(run_multi, inputs=[image_in, *actions, fs, ugs, steps,
                                       eta, seed], outputs=[video_out])
    return demo


def main(argv=None):
    p = argparse.ArgumentParser("open-pandora-app")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--port", type=int, default=10041)  # gradio_app.py:214
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio is not installed in this environment; use the CLI:\n"
              "  python -m open_pandora_tpu.pipeline.cli --help",
              file=sys.stderr)
        return 2

    from open_pandora_tpu.eval.vbench import _build_chat

    ns = argparse.Namespace(debug=args.debug, ckpt=args.ckpt,
                            tokenizer=args.tokenizer, height=320, width=512,
                            ddim_steps=50)
    chat = _build_chat(ns)
    build_app(chat).launch(server_port=args.port, server_name="0.0.0.0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
