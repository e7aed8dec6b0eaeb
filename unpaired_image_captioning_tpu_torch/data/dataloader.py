"""Caption data loader (counterpart of
`unpaired_image_captioning_tpu/data/dataloader.py`).

Parity: reference `misc/dataloader/dataloader.py:24-299` (AIC) and
`dataloader_coco.py` (COCO twin):

- vocab/splits from `*_talk.json` (images[{split,id,file_path}], ix_to_word),
  labels from the label file (`labels` [M, L], `label_start_ix` /
  `label_end_ix` 1-indexed, `label_length`), `.npz` or HDF5
  (`data/arrays.py`: the suffix picks the reader);
- per-image features from dirs (`fc` .npy/.npz, `att` .npz, box geometry +
  class-prob attribute vectors, dataloader.py:304-333), or from one `fc` /
  `att` file (`input_fc_h5` / `input_att_h5`, rows by image index, again
  `.npz` or HDF5): att l2-normalized when `norm_att_feat`, box geometry
  `[x1/w, y1/h, x2/w, y2/h, area]` appended (+5 dims) when `use_box`,
  cls-probs mean-pooled to the 1601-d attribute vector;
- `get_batch` returns numpy: fc_feats/attri_feats/att_feats [B*seq_per_img
  replicated], labels [B*spi, L+2] (zero col 0 and end), masks (first-EOS
  inclusive), att_masks, gts (padded [B, R, L] + mask for on-device SCST),
  epoch-wrap flags, infos; an NMT batch piggybacks in the same dict
  (dataloader.py:291) when an NMT dataset is attached;
- iterator state save/restore for mid-epoch resume (train.py:49-51).

As in the JAX package: the att grid is padded to a power-of-two bucket
capped at `max_att_len`, gts are padded tensors instead of ragged lists,
and `get_batch` is a plan phase (every draw of the loader's state) and a
feature-assembly phase (file reads and padding, no state: a
`FeatureReader`, which the feature workers of `data/prefetch.py` run from
a pickled copy). The
multi-host striping of the training split waits for scale-out (ROADMAP
A14), and `feat_dtype="bfloat16"` for the compute dtype (A15).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..vocab import CaptionVocab
from .arrays import open_array, read_arrays
from .nmt_dataset import NMTDataset


class FeatureReader:
    """The per-image feature reads of `CaptionDataLoader` (dirs, in-memory
    arrays or one `fc` / `att` file), padded to the att bucket. It holds
    no iterator or RNG state, so a pickled copy reads what the original
    reads: the feature workers of `data/prefetch.py` receive one. HDF5
    handles do not pickle; a copy holds none until `reopen`."""

    def __init__(self, *, images: list, input_fc_dir: str = "",
                 input_att_dir: str = "", input_box_dir: str = "",
                 input_box_cls_prob_dir: str = "", use_box: int = 0,
                 norm_att_feat: int = 0, norm_box_feat: int = 0,
                 use_box_cls_prob: int = 0, att_feat_size: int = 2048,
                 attri_feat_size: int = 1601, max_att_len: int = 196,
                 input_fc_h5: str = "", input_att_h5: str = "",
                 in_memory: Optional[dict] = None):
        self.images = images
        self.input_fc_dir = input_fc_dir
        self.input_att_dir = input_att_dir
        self.input_box_dir = input_box_dir
        self.input_box_cls_prob_dir = input_box_cls_prob_dir
        self.use_box = use_box
        self.norm_att_feat = norm_att_feat
        self.norm_box_feat = norm_box_feat
        self.use_box_cls_prob = use_box_cls_prob
        self.att_feat_size = att_feat_size
        self.attri_feat_size = attri_feat_size
        self.max_att_len = max_att_len
        self._mem = in_memory  # {'fc': {id: arr}, 'att': {...}, ...} for tests
        self._fc_h5_path = input_fc_h5
        self._att_h5_path = input_att_h5
        self._fc_h5 = open_array(input_fc_h5, "fc") if input_fc_h5 else None
        self._att_h5 = (open_array(input_att_h5, "att") if input_att_h5
                        else None)

    def _hdf5_features(self):
        """(attribute, path, dataset name) of each feature file read
        through HDF5 (the `.npz` route holds plain arrays)."""
        return [(attr, path, name) for attr, path, name in (
            ("_fc_h5", self._fc_h5_path, "fc"),
            ("_att_h5", self._att_h5_path, "att"))
            if path and not path.endswith(".npz")]

    def reopen(self) -> None:
        """Re-create the HDF5 feature handles (in a feature worker: HDF5
        handles cannot be pickled, and inherited ones share file state
        with the parent). The `.npz` route has none and imports no
        h5py."""
        for attr, path, name in self._hdf5_features():
            setattr(self, attr, open_array(path, name))

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        for attr, _, _ in self._hdf5_features():
            state[attr] = None
        return state

    def _load(self, kind: str, img_id) -> Optional[np.ndarray]:
        if self._mem is not None:
            d = self._mem.get(kind)
            return None if d is None else np.asarray(d[str(img_id)])
        dirs = {"fc": self.input_fc_dir, "att": self.input_att_dir,
                "box": self.input_box_dir, "cls": self.input_box_cls_prob_dir}
        d = dirs[kind]
        if not d:
            return None
        for ext, loader in ((".npz", lambda p: np.load(p)["feat"]),
                            (".npy", np.load)):
            p = os.path.join(d, str(img_id) + ext)
            if os.path.exists(p):
                return loader(p)
        raise FileNotFoundError(
            f"feature {kind} for image {img_id} not found in {d}")

    def fetch_image(self, ix: int):
        img = self.images[ix]
        img_id = img.get("id", ix)
        if self._fc_h5 is not None:
            fc = np.asarray(self._fc_h5[ix], np.float32)
        else:
            fc = self._load("fc", img_id)
        if self._att_h5 is not None:
            att = np.asarray(self._att_h5[ix], np.float32)
        else:
            att = self._load("att", img_id)
        attri = None
        if att is not None:
            att = att.reshape(-1, att.shape[-1]).astype(np.float32)
            if self.norm_att_feat:
                att = att / np.maximum(
                    np.linalg.norm(att, axis=1, keepdims=True), 1e-8)
            if self.use_box:
                box = self._load("box", img_id)
                if box is not None:
                    w = float(img.get("width", 1.0)) or 1.0
                    h = float(img.get("height", 1.0)) or 1.0
                    x1, y1 = box[:, 0] / w, box[:, 1] / h
                    x2, y2 = box[:, 2] / w, box[:, 3] / h
                    area = (x2 - x1) * (y2 - y1)
                    geo = np.stack([x1, y1, x2, y2, area],
                                   axis=1).astype(np.float32)
                    if self.norm_box_feat:
                        att = att / np.maximum(
                            np.linalg.norm(att, axis=1, keepdims=True), 1e-8)
                    att = np.concatenate([att, geo], axis=1)
                    # sort by box size, biggest first (dataloader.py:330-332)
                    order = np.argsort(-area, kind="stable")
                    att = att[order]
        if self.use_box_cls_prob:
            cls = self._load("cls", img_id)
            if cls is not None:
                attri = cls.reshape(-1, cls.shape[-1]).mean(
                    axis=0).astype(np.float32)
        if attri is None:
            attri = np.zeros((self.attri_feat_size,), np.float32)
        if fc is None:
            fc = (att.mean(axis=0) if att is not None
                  else np.zeros((self.att_feat_size,), np.float32))
        return fc.astype(np.float32).reshape(-1), att, attri, img

    def gather(self, ixs: List[int]) -> dict:
        """Feature IO + padding for the image indices `ixs`, one row an
        image."""
        bs = len(ixs)
        fc_list, att_list, attri_list, att_lens = [], [], [], []
        for ix in ixs:
            fc, att, attri, _ = self.fetch_image(ix)
            fc_list.append(fc)
            att_list.append(att)
            attri_list.append(attri)
            att_lens.append(0 if att is None
                            else min(len(att), self.max_att_len))

        # shape-stable padding: the batch max rounded up to a power-of-two
        # bucket (capped at max_att_len), so variable grids give at most
        # log2(max_att_len) distinct batch shapes
        max_att = max(max(att_lens), 1)
        bucket = 1
        while bucket < max_att:
            bucket *= 2
        max_att = min(bucket, self.max_att_len)
        att_dim = (self.att_feat_size + (5 if self.use_box else 0))
        att_feats = np.zeros((bs, max_att, att_dim), np.float32)
        att_masks = np.zeros((bs, max_att), np.float32)
        for i, att in enumerate(att_list):
            if att is None:
                continue
            L = att_lens[i]
            att_feats[i, :L] = att[:L]
            att_masks[i, :L] = 1.0

        return {"fc_feats": np.stack(fc_list).astype(np.float32,
                                                     copy=False),
                "att_feats": att_feats,
                "attri_feats": np.stack(attri_list).astype(np.float32,
                                                           copy=False),
                "att_masks": att_masks}


class CaptionDataLoader:
    def __init__(self, *, input_json: str, input_label_h5: str,
                 input_fc_dir: str = "", input_att_dir: str = "",
                 input_box_dir: str = "", input_box_cls_prob_dir: str = "",
                 batch_size: int = 16, seq_per_img: int = 5,
                 use_box: int = 0, norm_att_feat: int = 0,
                 norm_box_feat: int = 0, use_box_cls_prob: int = 0,
                 att_feat_size: int = 2048, attri_feat_size: int = 1601,
                 max_att_len: int = 196, max_gts: int = 5,
                 input_fc_h5: str = "", input_att_h5: str = "",
                 nmt_dataset: Optional[NMTDataset] = None,
                 in_memory: Optional[dict] = None, seed: int = 123,
                 feat_dtype: str = "float32"):
        if feat_dtype != "float32":
            raise NotImplementedError(
                f"feat_dtype={feat_dtype!r}: the port assembles features in "
                "f32 until the compute dtype lands (ROADMAP A15)")
        self.batch_size = batch_size
        self.seq_per_img = seq_per_img
        self.use_box = use_box
        self.use_box_cls_prob = use_box_cls_prob
        self.norm_att_feat = norm_att_feat
        self.norm_box_feat = norm_box_feat
        self.att_feat_size = att_feat_size
        self.attri_feat_size = attri_feat_size
        self.max_att_len = max_att_len
        self.max_gts = max_gts
        self.nmt = nmt_dataset
        self.rng = np.random.RandomState(seed)

        self.input_fc_dir = input_fc_dir
        self.input_att_dir = input_att_dir
        self.input_box_dir = input_box_dir
        self.input_box_cls_prob_dir = input_box_cls_prob_dir

        with open(input_json, "r", encoding="utf-8") as f:
            self.info = json.load(f)
        self.vocab = CaptionVocab(self.info["ix_to_word"])
        self.images = self.info["images"]
        self.features = FeatureReader(
            images=self.images, input_fc_dir=input_fc_dir,
            input_att_dir=input_att_dir, input_box_dir=input_box_dir,
            input_box_cls_prob_dir=input_box_cls_prob_dir, use_box=use_box,
            norm_att_feat=norm_att_feat, norm_box_feat=norm_box_feat,
            use_box_cls_prob=use_box_cls_prob, att_feat_size=att_feat_size,
            attri_feat_size=attri_feat_size, max_att_len=max_att_len,
            input_fc_h5=input_fc_h5, input_att_h5=input_att_h5,
            in_memory=in_memory)

        arrays = read_arrays(input_label_h5)
        self.labels = arrays["labels"].astype(np.int32)
        self.label_start_ix = arrays["label_start_ix"].astype(np.int64)
        self.label_end_ix = arrays["label_end_ix"].astype(np.int64)
        self.seq_length = self.labels.shape[1]

        self.split_ix: Dict[str, List[int]] = {"train": [], "val": [],
                                               "test": []}
        for ix, img in enumerate(self.images):
            split = img.get("split", "train")
            if split == "restval":
                split = "train"
            if split in self.split_ix:
                self.split_ix[split].append(ix)
        self.iterators = {k: 0 for k in self.split_ix}
        self._perm = {k: np.asarray(v, np.int64)
                      for k, v in self.split_ix.items()}
        if len(self._perm["train"]):
            self.rng.shuffle(self._perm["train"])

    # -- iterator state (mid-epoch resume, train.py:49-51) -------------------
    def state_dict(self) -> dict:
        """The iterators, the split orders and the RNG, as JSON-ready lists
        (with the attached NMT dataset's under "nmt")."""
        rng_state = self.rng.get_state()
        state = {"iterators": dict(self.iterators),
                 "perm": {k: v.tolist() for k, v in self._perm.items()},
                 "rng": [rng_state[0], np.asarray(rng_state[1]).tolist(),
                         rng_state[2], rng_state[3], rng_state[4]]}
        if self.nmt is not None:
            state["nmt"] = self.nmt.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        self.iterators.update(state["iterators"])
        for k, v in state.get("perm", {}).items():
            self._perm[k] = np.asarray(v, np.int64)
        if "rng" in state:
            r = state["rng"]
            self.rng.set_state((r[0], np.asarray(r[1], np.uint32), int(r[2]),
                                int(r[3]), float(r[4])))
        if self.nmt is not None and "nmt" in state:
            self.nmt.load_state_dict(state["nmt"])

    def reset_iterator(self, split: str) -> None:
        self.iterators[split] = 0

    def _fetch_captions(self, ix: int) -> np.ndarray:
        """seq_per_img captions [spi, L] (random block / sample-with-repeat
        parity: dataloader.py:188-208)."""
        ix1 = self.label_start_ix[ix] - 1
        ix2 = self.label_end_ix[ix] - 1
        ncap = ix2 - ix1 + 1
        spi = self.seq_per_img
        if ncap <= 0:
            return np.zeros((spi, self.seq_length), np.int32)
        if ncap < spi:
            picks = self.rng.randint(ix1, ix2 + 1, size=spi)
            return self.labels[picks]
        start = self.rng.randint(ix1, ix2 - spi + 2)
        return self.labels[start: start + spi]

    def _gts(self, ix: int):
        ix1 = self.label_start_ix[ix] - 1
        ix2 = self.label_end_ix[ix] - 1
        caps = self.labels[ix1: ix2 + 1][: self.max_gts]
        out = np.zeros((self.max_gts, self.seq_length), np.int32)
        mask = np.zeros((self.max_gts,), np.float32)
        out[: len(caps)] = caps
        mask[: len(caps)] = 1.0
        return out, mask

    def references(self, split: str) -> Dict:
        """image id -> the decoded reference captions of every image of
        `split` (`language_eval`'s references)."""
        refs = {}
        for ix in self.split_ix[split]:
            i1 = self.label_start_ix[ix] - 1
            i2 = self.label_end_ix[ix] - 1
            iid = self.images[ix].get("id", ix)
            refs[iid] = self.vocab.decode_sequence(self.labels[i1: i2 + 1])
        return refs

    # -- batching --------------------------------------------------------------
    def _rep(self, x):
        # seq_per_img replication, one definition for plan_batch
        # (labels/gts) and assemble_features (features)
        return np.repeat(x, self.seq_per_img, axis=0)

    def plan_batch(self, split: str, batch_size: Optional[int] = None) -> dict:
        """Everything but the feature IO: draws the image indices (shuffling
        on wrap), captions, gts, and the piggybacked NMT batch. Consumes
        loader RNG/iterator state exactly like get_batch."""
        bs = batch_size or self.batch_size
        spi = self.seq_per_img
        ixs = []
        wrapped = False
        pool = self._perm[split]
        n = len(pool)
        for _ in range(bs):
            i = self.iterators[split]
            if i >= n:
                self.iterators[split] = 0
                if split == "train":
                    self.rng.shuffle(pool)
                wrapped = True
                i = 0
            ixs.append(int(pool[i]))
            self.iterators[split] = i + 1

        info_list, label_list, gts_list, gts_mask_list = [], [], [], []
        for ix in ixs:
            img = self.images[ix]
            info_list.append({"ix": ix, "id": img.get("id", ix),
                              "file_path": img.get("file_path", "")})
            label_list.append(self._fetch_captions(ix))
            g, gm = self._gts(ix)
            gts_list.append(g)
            gts_mask_list.append(gm)

        labels = np.zeros((bs * spi, self.seq_length + 2), np.int32)
        labels[:, 1:-1] = np.concatenate(label_list, axis=0)
        nonzero = labels > 0
        masks = np.zeros_like(labels, np.float32)
        masks[:, 0] = 1.0
        masks[:, 1:] = np.logical_or(nonzero[:, 1:], nonzero[:, :-1])

        rep = self._rep
        plan = {
            "ixs": ixs,
            "labels": labels,
            "masks": masks,
            "gts": rep(np.stack(gts_list)),
            "gts_masks": rep(np.stack(gts_mask_list)),
            "infos": info_list,
            "bounds": {"it_pos_now": self.iterators[split],
                       "it_max": n, "wrapped": wrapped},
        }
        if self.nmt is not None:
            nmt_batch, nmt_wrapped = self.nmt.next_batch()
            plan["nmt"] = nmt_batch
            plan["nmt_wrapped"] = nmt_wrapped
        return plan

    def gather_features(self, ixs: List[int]) -> dict:
        """The planned images' features, one row an image
        (`FeatureReader.gather`)."""
        return self.features.gather(ixs)

    def replicate(self, feats: dict) -> dict:
        """Each image's feature rows repeated for its seq_per_img captions
        (new arrays)."""
        return {k: self._rep(v) for k, v in feats.items()}

    def assemble_features(self, ixs: List[int]) -> dict:
        """The batch's features: `gather_features`, replicated."""
        return self.replicate(self.gather_features(ixs))

    def reopen_features(self) -> None:
        """Re-create the HDF5 feature handles (`FeatureReader.reopen`)."""
        self.features.reopen()

    def get_batch(self, split: str, batch_size: Optional[int] = None) -> dict:
        plan = self.plan_batch(split, batch_size)
        feats = self.assemble_features(plan.pop("ixs"))
        plan.update(feats)
        return plan
