"""The port's copy of the demo-corpus fetcher (``data/fetch.py``) on the
fabricated slt_arctic-shaped archives of ``tests/test_fetch.py``: the same
four cases against the copy, and the tree it unpacks equal, file for file
and byte for byte, to the JAX package's. No case touches the network: the
download leg's failure is made by replacing ``urllib.request.urlopen``."""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import os
import tarfile
import urllib.error

import numpy as np
import pytest

from percivaltts_tpu.data.fetch import fetch_demo_corpus as jax_fetch_demo_corpus
from percivaltts_tpu_torch.data import fetch
from percivaltts_tpu_torch.data.fetch import fetch_demo_corpus
from test_fetch import QUESTIONS, _add_bytes, _lab_text, _make_archive, _tiny_wav_bytes


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_fetch_from_local_archive_normalizes_layout(tmp_path):
    arc = _make_archive(str(tmp_path / "c.tar.gz"))
    dest = str(tmp_path / "corpus")
    info = fetch_demo_corpus(dest, archive=arc)
    assert info["n_utts"] == 2
    assert info["label_dir"] == "label_state_align"
    assert os.path.exists(os.path.join(dest, "wav", "utt1.wav"))
    assert os.path.exists(os.path.join(dest, "label_state_align", "utt2.lab"))
    assert os.path.exists(os.path.join(dest, "questions.hed"))
    with open(os.path.join(dest, "fileids.scp")) as f:
        assert [ln.strip() for ln in f if ln.strip()] == ["utt1", "utt2"]
    theirs = str(tmp_path / "jax_corpus")
    assert jax_fetch_demo_corpus(theirs, archive=arc) == {
        k: (v.replace(dest, theirs) if isinstance(v, str) else v) for k, v in info.items()}
    assert _tree(dest) == _tree(theirs)

    # the fetched tree composes through the port
    from percivaltts_tpu_torch.config import Configuration, DataConfig, VocoderConfig
    from percivaltts_tpu_torch.data.compose import compose

    cfg = Configuration(
        workdir=str(tmp_path / "exp"),
        data=DataConfig(corpus_dir=dest, question_file=os.path.join(dest, "questions.hed"),
                        fileids=os.path.join(dest, "fileids.scp"), label_dim=0, num_valid=0,
                        num_test=1),
        vocoder=VocoderConfig(fs=16000, spec_size=17, nm_size=5),
    )
    cc = compose(cfg, device="cpu")
    assert len(cc.train) + len(cc.valid) + len(cc.test) == 2
    for ds in (cc.train, cc.test):
        for c in ds.cmps:
            assert np.isfinite(c).all()


def test_fetch_phone_aligned_and_derived_fileids(tmp_path):
    arc = _make_archive(str(tmp_path / "c.tar.gz"), label_dir="label_phone_align",
                        with_fileids=False, nested="deep/nest")
    dest = str(tmp_path / "corpus")
    assert fetch.main([dest, "--archive", arc]) == 0  # the module's command line
    with open(os.path.join(dest, "fileids.scp")) as f:
        assert [ln.strip() for ln in f if ln.strip()] == ["utt1", "utt2"]
    assert os.path.isdir(os.path.join(dest, "label_phone_align"))
    theirs = str(tmp_path / "jax_corpus")
    jax_fetch_demo_corpus(theirs, archive=arc)
    assert _tree(dest) == _tree(theirs)


def test_fetch_rejects_path_traversal(tmp_path):
    arc = str(tmp_path / "evil.tar.gz")
    with tarfile.open(arc, "w:gz") as tar:
        _add_bytes(tar, "../evil.txt", b"nope")
    with pytest.raises(ValueError, match="escapes"):
        fetch_demo_corpus(str(tmp_path / "corpus"), archive=arc)
    assert not os.path.exists(str(tmp_path.parent / "evil.txt"))


def test_fetch_errors_are_actionable(tmp_path, monkeypatch):
    arc = str(tmp_path / "junk.tar.gz")
    with tarfile.open(arc, "w:gz") as tar:
        _add_bytes(tar, "readme.txt", b"hello")
    with pytest.raises(FileNotFoundError, match="wav/"):
        fetch_demo_corpus(str(tmp_path / "c1"), archive=arc)

    arc2 = _make_archive(str(tmp_path / "noq.tar.gz"), with_questions=False)
    with pytest.raises(FileNotFoundError, match="questions"):
        fetch_demo_corpus(str(tmp_path / "c2"), archive=arc2)

    arc3 = str(tmp_path / "gap.tar.gz")
    with tarfile.open(arc3, "w:gz") as tar:
        _add_bytes(tar, "wav/utt1.wav", _tiny_wav_bytes())
        _add_bytes(tar, "label_state_align/utt1.lab", _lab_text().encode())
        _add_bytes(tar, "questions.hed", QUESTIONS.encode())
        _add_bytes(tar, "fileids.scp", b"utt1\nmissing_utt\n")
    with pytest.raises(FileNotFoundError, match="missing_utt"):
        fetch_demo_corpus(str(tmp_path / "c3"), archive=arc3)

    # a failed download says how to resume from a local archive
    def offline(*args, **kwargs):
        raise urllib.error.URLError("no network")

    monkeypatch.setattr(fetch.urllib.request, "urlopen", offline)
    with pytest.raises(RuntimeError, match="--archive"):
        fetch_demo_corpus(str(tmp_path / "c4"), url="http://localhost:9/never.tar.gz")
