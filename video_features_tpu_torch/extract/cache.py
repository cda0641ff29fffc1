"""Content-addressed feature cache (``--cache_dir``, ``--cache_hash``).

Counterpart of ``video_features_tpu/extract/cache.py``, copied as it is
(stdlib only) but for one thing: :func:`config_digest` is salted with
this package's name. The two packages agree within tolerance, not bit
for bit, so in a ``--cache_dir`` both share, one package's entries are a
miss for the other, never a hit. (:func:`content_hash` is the JAX
package's byte for byte: only the digest tells the packages apart. A
knob of the JAX package's digest that the port's config lacks reads as
None here; the salt keeps that from ever matching a JAX entry either.)

``host_preprocess`` is in the digest (``pil`` and ``native`` give
features within ~1/255 per pixel of each other, not equal); ``decoder``
is not, as in the JAX package: the two backends decode the same bytes
(``tests/test_torch_native.py``'s width sweep), so they share entries.

The CPU and the card agree within tolerance too, not bit for bit, so
the digest also holds the device kind (``cpu`` under ``--cpu``, else
``cuda``): in a shared ``--cache_dir`` an entry a ``--cpu`` run wrote is
a miss for a run on the card, and the other way round.

Completed features are keyed by (content hash, extraction-config digest):
the hash names the *bytes* of the input media, the digest names every
knob that can change the extracted values or their serialized form. A
repeat request for a video already extracted under the same config is a
store lookup + file copy instead of a decode + forward pass.

Layout on disk (shareable across hosts on a common filesystem)::

    <root>/<hh>/<content_hash>/<config_digest>/
        entry.json            # keys -> payload file names, provenance
        <key>.npy | <key>.pkl # one payload per feature key

Population is claim-by-rename: a writer stages the entry under
``<root>/.tmp/<uuid>/`` and ``os.rename``\\ s the whole directory onto the
entry path. Renaming onto an existing non-empty directory fails, so when
two replicas compute the same key concurrently exactly one wins and the
loser's work degrades to a no-op (its next lookup is a hit). A torn
entry can never be valid: payloads are copied from files the sink
already committed atomically (io/sink.py), the staged directory only
becomes visible via the single rename, and ``lookup`` re-validates
``entry.json`` plus each payload's magic bytes before trusting anything.

Hashing is ``fast`` by default — size + head + a few sampled chunks +
tail through sha256 — so admission never streams a multi-GB file;
``--cache_hash full`` streams every byte for collision-paranoid setups.
A (path, size, mtime_ns) memo makes the hash free for repeat lookups
and for multi-model fan-out requests that would otherwise hash the same
bytes once per model. Audio inputs (VGGish wav files) hash through the
same byte-level path — nothing here is video-specific.

Admission-path code: it imports nothing of torch (same rule as
serve/lifecycle.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional

from video_features_tpu_torch.io.sink import atomic_copy, output_file_name

# fast-hash geometry: 1 MiB head (container metadata + first GOPs), four
# 256 KiB chunks sampled at evenly spaced offsets, and a 256 KiB tail
# (mp4 moov atoms often live there) — plus the exact byte size, so two
# files must agree on size AND ~2 MiB of spread-out content to collide
_FAST_HEAD = 1 << 20
_FAST_CHUNK = 1 << 18
_FAST_SAMPLES = 4

HASH_MODES = ("fast", "full")

# (abspath, size, mtime_ns, mode) -> hex digest. Bounded LRU: a
# long-lived serve daemon must not grow this forever. Guarded — the
# daemon's admission thread and the extractor's decode workers both
# hash.
_MEMO_CAP = 4096
_MEMO: "OrderedDict[tuple, str]" = OrderedDict()
_MEMO_LOCK = threading.Lock()


def content_hash(path: str, mode: str = "fast") -> str:
    """sha256 content hash of ``path`` (hex), memoized on
    (path, size, mtime_ns, mode) so repeat lookups and same-request
    fan-out never re-read the bytes. Raises OSError for unreadable
    paths — callers treat that as uncacheable, never as a hit."""
    if mode not in HASH_MODES:
        raise ValueError(f"unknown cache hash mode: {mode!r}")
    ap = os.path.abspath(path)
    st = os.stat(ap)
    memo_key = (ap, st.st_size, st.st_mtime_ns, mode)
    with _MEMO_LOCK:
        hit = _MEMO.get(memo_key)
        if hit is not None:
            _MEMO.move_to_end(memo_key)
            return hit
    digest = _hash_bytes(ap, st.st_size, mode)
    with _MEMO_LOCK:
        _MEMO[memo_key] = digest
        while len(_MEMO) > _MEMO_CAP:
            _MEMO.popitem(last=False)
    return digest


def _hash_bytes(path: str, size: int, mode: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        if mode == "full":
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
            return h.hexdigest()
        # fast: the size is part of the preimage — sampled chunks alone
        # would let a truncated copy collide with its original
        h.update(str(size).encode("ascii"))
        h.update(b"\x00")
        h.update(f.read(_FAST_HEAD))
        body = size - _FAST_HEAD - _FAST_CHUNK
        if body > 0:
            for i in range(1, _FAST_SAMPLES + 1):
                f.seek(_FAST_HEAD + body * i // (_FAST_SAMPLES + 1))
                h.update(f.read(_FAST_CHUNK))
            f.seek(size - _FAST_CHUNK)
            h.update(f.read(_FAST_CHUNK))
    return h.hexdigest()


# every knob that changes extracted values or their serialized form —
# the same family of knobs that keys fused executables (model identity,
# sampling grid, preprocess placement, numerics). Knobs that only move
# work around (decode_workers, video_batch, retries, telemetry, decoder) are
# deliberately absent: they must share cache entries. Missing a knob
# here would serve stale features; including a no-op knob only costs a
# spurious miss — when in doubt, include.
_DIGEST_FIELDS = (
    "feature_type",
    "extraction_fps",
    "fps_retarget",
    "extract_method",
    "stack_size",
    "step_size",
    "streams",
    "flow_type",
    "batch_size",
    "resize_to_smaller_edge",
    "side_size",
    "dtype",
    "weights_path",
    "allow_random_init",
    "host_preprocess",
    "preprocess",
    "spatial_bucket",
    "frame_delta_threshold",
    "attn",
    "conv3d_impl",
    "on_extraction",
)


# the salt of every digest: the package that computed the entry
DIGEST_SALT = "video_features_tpu_torch"


def config_digest(cfg) -> str:
    """sha256 over the output-affecting knobs of an ExtractionConfig and
    :data:`DIGEST_SALT` (hex, truncated to 16 chars — it is a directory
    name, and 64 bits of config space is plenty). Any change to a listed
    knob is a new cache namespace: invalidation IS the digest. Knobs the
    port's config lacks read as None. The device kind (``cpu`` under
    ``--cpu``, else ``cuda``) is in the digest too."""
    doc = {"package": DIGEST_SALT, "device": "cpu" if getattr(cfg, "cpu", False) else "cuda"}
    for name in _DIGEST_FIELDS:
        value = getattr(cfg, name, None)
        if isinstance(value, (list, tuple)):
            value = list(value)
        doc[name] = value
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def feature_keys_for(cfg) -> List[str]:
    """The feature keys a config's extractor will produce, derivable
    without building the model (the serve admission path must not pay a
    build to answer a lookup). Mirrors BaseExtractor.feature_keys and
    the I3D override; a mismatch can only cause a miss, never a wrong
    hit — lookup requires every requested key to be present."""
    if cfg.feature_type == "i3d":
        return list(cfg.streams) if cfg.streams else ["rgb", "flow"]
    return [cfg.feature_type]


_PAYLOAD_MAGIC = {
    ".npy": b"\x93NUMPY",
    ".pkl": b"\x80",  # pickle protocol >= 2 opcode
}


def _payload_ok(path: str) -> bool:
    """Cheap torn-file detector: the payload must exist, be non-empty,
    and carry its format's magic bytes. A partially-copied or truncated
    entry fails here and the lookup degrades to a miss."""
    ext = os.path.splitext(path)[1]
    magic = _PAYLOAD_MAGIC.get(ext)
    if magic is None:
        return False
    try:
        with open(path, "rb") as f:
            return f.read(len(magic)) == magic
    except OSError:
        return False


class FeatureCache:
    """One content-addressed store rooted at a directory.

    Stateless beyond the root path + hash mode: every method re-reads
    the filesystem, so multiple processes (and hosts, on shared
    storage) can point at the same root with no coordination beyond
    the claim-by-rename publish protocol."""

    def __init__(self, root: str, hash_mode: str = "fast") -> None:
        if hash_mode not in HASH_MODES:
            raise ValueError(f"unknown cache hash mode: {hash_mode!r}")
        self.root = os.path.abspath(root)
        self.hash_mode = hash_mode

    def content_hash(self, path: str) -> str:
        return content_hash(path, self.hash_mode)

    def entry_dir(self, chash: str, digest: str) -> str:
        return os.path.join(self.root, chash[:2], chash, digest)

    def lookup(
        self, chash: str, digest: str, feature_keys
    ) -> Optional[Dict[str, str]]:
        """{key: payload path} when a VALID entry covers every requested
        key, else None. Corruption anywhere — unreadable/garbled
        entry.json, a missing key, a payload without its magic — is a
        miss; a wrong hit is the one failure mode this layer must not
        have."""
        d = self.entry_dir(chash, digest)
        try:
            with open(os.path.join(d, "entry.json"), "r", encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        names = meta.get("keys") if isinstance(meta, dict) else None
        if not isinstance(names, dict):
            return None
        out: Dict[str, str] = {}
        for key in feature_keys:
            fname = names.get(key)
            # payload names come from entry.json — refuse anything that
            # could escape the entry directory
            if not isinstance(fname, str) or fname != os.path.basename(fname):
                return None
            path = os.path.join(d, fname)
            if not _payload_ok(path):
                return None
            out[key] = path
        return out

    def publish(
        self, chash: str, digest: str, files: Dict[str, str], feature_type: str = ""
    ) -> bool:
        """Copy already-committed output files ({key: path}) into the
        store. Returns True when this call created the entry, False
        when another writer got there first (the claim-by-rename loss —
        a no-op, not an error) or a source file vanished."""
        entry = self.entry_dir(chash, digest)
        if os.path.isdir(entry):
            return False
        stage = os.path.join(self.root, ".tmp", uuid.uuid4().hex)
        try:
            os.makedirs(stage)
            names = {}
            for key, src in files.items():
                fname = key.replace("/", "-") + os.path.splitext(src)[1]
                shutil.copyfile(src, os.path.join(stage, fname))
                names[key] = fname
            meta = {
                "format_version": 1,
                "content_hash": chash,
                "config_digest": digest,
                "feature_type": feature_type,
                "hash_mode": self.hash_mode,
                "keys": names,
            }
            with open(os.path.join(stage, "entry.json"), "w", encoding="utf-8") as f:
                json.dump(meta, f, sort_keys=True)
            os.makedirs(os.path.dirname(entry), exist_ok=True)
            os.rename(stage, entry)  # the claim: fails if someone else won
            return True
        except OSError:
            shutil.rmtree(stage, ignore_errors=True)
            return False

    def materialize(
        self, cached: Dict[str, str], dests: Dict[str, str]
    ) -> List[str]:
        """Copy cached payloads to their expected output locations
        (tmp + rename, like the sink: a kill mid-copy must not leave a
        truncated file --resume would trust). Returns the dest paths in
        ``dests`` order; raises OSError if a payload disappears."""
        out = []
        for key, dest in dests.items():
            atomic_copy(cached[key], dest)
            out.append(dest)
        return out

    def dest_files(
        self, feature_keys, video_path: str, output_path: str,
        on_extraction: str, output_direct: bool = False,
    ) -> Dict[str, str]:
        """{key: expected output file} — the per-key companion of
        io/sink.py's expected_output_files (which flattens and dedups;
        materialize needs the key association)."""
        import pathlib

        stem = pathlib.Path(video_path).stem
        return {
            key: os.path.join(
                output_path,
                output_file_name(stem, key, on_extraction, output_direct),
            )
            for key in feature_keys
        }
