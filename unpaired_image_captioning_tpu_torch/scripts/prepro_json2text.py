"""Caption json <-> text conversion CLI (the port's copy of
`unpaired_image_captioning_tpu/scripts/prepro_json2text.py`):

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_json2text \\
        --mode json2text --input preds.json --output preds.txt

Parity: reference `scripts/prepro_json2text.py` and the converters in
misc/utils.py (:119-161) used by the subprocess pivot pipeline, here the
port's `utils/text.py`. `text2json` and `text2textid` take `--ids`, a file
with one image id per line.
"""

from __future__ import annotations

import argparse

from ..utils.text import cocojson2text, text2cocojson, text2textid


def main(argv=None):
    p = argparse.ArgumentParser("prepro_json2text")
    p.add_argument("--mode", choices=["json2text", "text2json", "text2textid"],
                   required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--ids", help="file with one image id per line")
    a = p.parse_args(argv)

    ids = None
    if a.ids:
        with open(a.ids) as f:
            ids = [l.strip() for l in f]
    if a.mode == "json2text":
        cocojson2text(a.input, a.output)
    elif a.mode == "text2json":
        assert ids, "--ids required"
        text2cocojson(a.input, ids, a.output)
    else:
        assert ids, "--ids required"
        text2textid(a.input, ids, a.output)
    print(f"{a.mode}: {a.input} -> {a.output}")


if __name__ == "__main__":
    main()
