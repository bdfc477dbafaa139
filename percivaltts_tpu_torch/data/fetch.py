"""Demo-corpus fetcher: download or unpack ``slt_arctic_merlin_full``
(the port's copy of ``percivaltts_tpu/data/fetch.py``; it imports no
framework).

    python -m percivaltts_tpu_torch.data.fetch /path/to/corpus [--archive FILE.tar.gz]

It normalizes whatever layout the archive carries into the Merlin layout
``compose`` reads: ``wav/``, ``label_state_align/`` (or phone),
``questions.hed``, ``fileids.scp``. Without a network the download fails
fast and says how to resume from a local archive (``--archive``); the
extraction (path traversal refused), layout discovery, normalization and
validation run on any archive.
"""

from __future__ import annotations

import os
import shutil
import sys
import tarfile
import tempfile
import urllib.error
import urllib.request
from typing import Dict, Optional

from percivaltts_tpu_torch.utils.logging import print_log

# Default source for the reference's demo corpus. The reference's own
# fetch URL is unverifiable (mount empty); this default points at the
# documented public home of the percivaltts demo data and is overridable
# via the env var or the url= argument the day it differs.
DEFAULT_URL = os.environ.get(
    "PERCIVALTTS_DEMO_URL",
    "https://github.com/gillesdegottex/percivaltts/releases/download/"
    "v1.0/slt_arctic_merlin_full.tar.gz",
)

# Directory/file names seen across Merlin-lineage slt_arctic bundles; the
# normalizer searches for these and maps them onto the layout compose
# expects (DataConfig defaults: wav_dir="wav", label_dir="label_state_align").
_LABEL_DIRS = ("label_state_align", "label_phone_align", "lab")
_FILEID_NAMES = (
    "fileids.scp",
    "file_id_list.scp",
    "file_id_list_full.scp",
    "file_id_list_demo.scp",
)


def _safe_extract(tar: tarfile.TarFile, dest: str) -> None:
    """Extract refusing path traversal (absolute members or ``..``)."""
    dest_real = os.path.realpath(dest)
    for m in tar.getmembers():
        target = os.path.realpath(os.path.join(dest, m.name))
        if not (target == dest_real or target.startswith(dest_real + os.sep)):
            raise ValueError(
                f"archive member escapes the extraction directory: {m.name!r}"
                " — refusing to extract (corrupt or hostile archive)"
            )
        if m.issym() or m.islnk():
            link_target = os.path.realpath(
                os.path.join(dest, os.path.dirname(m.name), m.linkname)
            )
            if not link_target.startswith(dest_real + os.sep):
                raise ValueError(
                    f"archive link member escapes the extraction directory: "
                    f"{m.name!r} -> {m.linkname!r}"
                )
    try:
        tar.extractall(dest, filter="data")
    except TypeError:  # filter= needs py3.12 / backports
        tar.extractall(dest)


def _find_corpus_root(tree: str) -> str:
    """Locate the directory holding ``wav/`` + a label dir, at any depth
    (archives commonly nest everything under a top-level folder)."""
    for root, dirs, _files in os.walk(tree):
        if "wav" in dirs and any(d in dirs for d in _LABEL_DIRS):
            return root
    raise FileNotFoundError(
        f"no Merlin-layout corpus found under {tree!r}: expected a directory "
        "containing wav/ plus one of "
        + "/".join(_LABEL_DIRS)
        + " — is this the slt_arctic_merlin_full archive?"
    )


def _download(url: str, dest: str, timeout: float = 30.0) -> str:
    out = os.path.join(dest, os.path.basename(url) or "corpus.tar.gz")
    print_log(f"downloading {url} ...")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(
            out, "wb"
        ) as f:
            shutil.copyfileobj(r, f, length=1 << 20)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise RuntimeError(
            f"could not download the demo corpus from {url}: {e}. "
            "If this machine has no network, download the archive on a "
            "networked machine and rerun with --archive "
            "/path/to/slt_arctic_merlin_full.tar.gz (or set "
            "PERCIVALTTS_DEMO_URL if the corpus moved). An offline "
            "synthetic substitute is available via `cli demo`."
        ) from e
    return out


def fetch_demo_corpus(
    dest_dir: str,
    url: str = DEFAULT_URL,
    archive: Optional[str] = None,
) -> Dict[str, object]:
    """Fetch (or unpack ``archive``) and normalize the demo corpus into
    ``dest_dir`` in the layout compose expects. Returns a summary dict
    with ``n_utts``, ``label_dir``, ``question_file``, ``fileids``."""
    os.makedirs(dest_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dest_dir) as tmp:
        if archive is None:
            archive = _download(url, tmp)
        if not os.path.exists(archive):
            raise FileNotFoundError(f"archive not found: {archive}")
        print_log(f"extracting {archive} ...")
        with tarfile.open(archive, "r:*") as tar:
            _safe_extract(tar, tmp)
        src = _find_corpus_root(tmp)

        # move wav/ + the first label dir present into dest
        label_dir = next(
            d for d in _LABEL_DIRS if os.path.isdir(os.path.join(src, d))
        )
        for d in ("wav", label_dir):
            target = os.path.join(dest_dir, d)
            if os.path.isdir(target):
                shutil.rmtree(target)
            shutil.move(os.path.join(src, d), target)

        # question set: prefer an explicit questions*.hed anywhere in the tree
        qfile = None
        for root, _dirs, files in os.walk(tmp):
            for fn in sorted(files):
                if fn.startswith("questions") and fn.endswith(".hed"):
                    qfile = os.path.join(root, fn)
                    break
            if qfile:
                break
        if qfile is None:
            raise FileNotFoundError(
                "no questions*.hed in the archive — compose needs the "
                "Merlin question set the labels were aligned with; pass the "
                "corpus's own question file via DataConfig.question_file"
            )
        qdest = os.path.join(dest_dir, "questions.hed")
        shutil.copyfile(qfile, qdest)

        # file-id list: use the archive's if present, else derive from wav/
        fdest = os.path.join(dest_dir, "fileids.scp")
        flist = None
        for root, _dirs, files in os.walk(tmp):
            for name in _FILEID_NAMES:
                if name in files:
                    flist = os.path.join(root, name)
                    break
            if flist:
                break
        if flist is not None:
            shutil.copyfile(flist, fdest)
        else:
            ids = sorted(
                fn[:-4]
                for fn in os.listdir(os.path.join(dest_dir, "wav"))
                if fn.endswith(".wav")
            )
            with open(fdest, "w") as f:
                f.write("\n".join(ids) + "\n")

    # validate: every listed id must have wav + label
    with open(fdest) as f:
        ids = [ln.strip() for ln in f if ln.strip()]
    missing = [
        uid
        for uid in ids
        if not (
            os.path.exists(os.path.join(dest_dir, "wav", uid + ".wav"))
            and os.path.exists(os.path.join(dest_dir, label_dir, uid + ".lab"))
        )
    ]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)}/{len(ids)} listed utterances are missing wav or "
            f"label files (first: {missing[0]!r}) — archive incomplete or "
            "layout drifted; see README 'Real corpora' for the expected tree"
        )
    print_log(
        f"demo corpus ready at {dest_dir}: {len(ids)} utterances, "
        f"labels in {label_dir}/"
    )
    return {
        "n_utts": len(ids),
        "label_dir": label_dir,
        "question_file": qdest,
        "fileids": fdest,
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Fetch the slt_arctic_merlin_full demo corpus and "
        "normalize it into the Merlin layout compose expects."
    )
    p.add_argument("dest", help="destination corpus directory")
    p.add_argument("--url", default=DEFAULT_URL)
    p.add_argument(
        "--archive",
        default=None,
        help="use a local .tar.gz instead of downloading",
    )
    a = p.parse_args(argv)
    info = fetch_demo_corpus(a.dest, url=a.url, archive=a.archive)
    print_log(
        "next: point DataConfig at it — corpus_dir="
        f"{a.dest!r}, question_file={info['question_file']!r}, "
        f"fileids={info['fileids']!r}"
        + (
            f", label_dir={info['label_dir']!r}"
            if info["label_dir"] != "label_state_align"
            else ""
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
