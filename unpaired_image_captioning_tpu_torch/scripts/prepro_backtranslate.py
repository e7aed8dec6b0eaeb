"""Back-translation / pseudo-pair generation (the port's copy of
`unpaired_image_captioning_tpu/scripts/prepro_backtranslate.py`):

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_backtranslate \\
        --input zh.txt --output en.txt --nmt_run run [--device cpu]

Parity: reference `scripts/prepro_bt_google.py:19-43` / `prepro_pseudo.py`
— the reference hits the googletrans web API. Here pseudo pairs come from
the port's own translator: `cli.translate` on the NMT of a run directory
of `cli.train` (`--nmt_run`), on the card unless `--device` names another
device. `--provider google` is kept for compatibility and raises: it needs
network access.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("prepro_backtranslate")
    p.add_argument("--input", required=True, help="one sentence per line")
    p.add_argument("--output", required=True)
    p.add_argument("--provider", choices=["nmt", "google"], default="nmt")
    p.add_argument("--nmt_run", help="run dir for provider=nmt")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--device", "-device", default="cuda",
                   help="torch device of the NMT (default: the card)")
    a = p.parse_args(argv)

    if a.provider == "google":
        raise SystemExit(
            "provider=google requires network access (googletrans); this "
            "environment is zero-egress — use --provider nmt with a trained "
            "translator checkpoint instead")
    assert a.nmt_run, "--nmt_run required for provider=nmt"
    from ..cli.translate import main as translate_main

    translate_main(["-model", a.nmt_run, "-src", a.input,
                    "-output", a.output, "-beam_size", str(a.beam_size),
                    "-device", a.device])
    print(f"back-translated {a.input} -> {a.output}")


if __name__ == "__main__":
    main()
