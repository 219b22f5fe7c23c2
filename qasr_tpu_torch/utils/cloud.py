"""Model cards and the checkpoint cache behind ``from_pretrained`` (port of
qasr_tpu/utils/cloud.py).

A card names a checkpoint's location; ``resolve_pretrained`` maps a card's
name to a file in an md5-keyed cache (the key is md5(location +
description), as NeMo's: a new location or description downloads anew).
Nothing here opens a network connection by itself: a download goes
through a fetcher, ``fetcher(url, dest)``, passed in or installed with
``set_default_fetcher`` (``file_fetcher`` copies ``file://`` URLs, for
mirrors on disk).  Without one, a card whose file is not cached resolves
to an error.
"""
from __future__ import annotations

import hashlib
import logging
import os
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional
from urllib.parse import unquote, urlparse

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class PretrainedModelInfo:
    """A model card: the name, the checkpoint's location, a description
    (with the published WERs)."""

    pretrained_model_name: str
    location: str
    description: str = ""


_NGC = "https://api.ngc.nvidia.com/v2/models/nvidia/nemospeechmodels/versions/1.0.0a5/files/"

MODEL_CARDS: List[PretrainedModelInfo] = [
    PretrainedModelInfo(
        "QuartzNet15x5Base-En", _NGC + "QuartzNet15x5Base-En.nemo",
        "QuartzNet15x5 trained on six datasets; WER 3.79% on LibriSpeech "
        "dev-clean, 10.05% on dev-other."),
    PretrainedModelInfo(
        "QuartzNet15x5NR-En", _NGC + "QuartzNet15x5NR-En.nemo",
        "QuartzNet15x5Base-En finetuned with RIR/noise augmentation; WER "
        "3.96% dev-clean, 10.14% dev-other."),
    PretrainedModelInfo(
        "QuartzNet5x5LS-En", _NGC + "QuartzNet5x5LS-En.nemo",
        "QuartzNet5x5 trained on LibriSpeech; WER 5.37% dev-clean, "
        "15.69% dev-other."),
    PretrainedModelInfo(
        "Jasper10x5Dr-En", _NGC + "Jasper10x5Dr-En.nemo",
        "Jasper10x5Dr trained on six datasets; WER 3.37% dev-clean, "
        "9.81% dev-other."),
]


def model_card(name: str) -> Optional[PretrainedModelInfo]:
    return next((c for c in MODEL_CARDS if c.pretrained_model_name == name), None)


def register_model_card(card: PretrainedModelInfo) -> None:
    """Add a card, or replace the one of the same name."""
    global MODEL_CARDS
    MODEL_CARDS = [c for c in MODEL_CARDS
                   if c.pretrained_model_name != card.pretrained_model_name] + [card]


Fetcher = Callable[[str, str], None]  # (url, destination path) -> None


def file_fetcher(url: str, dest: str) -> None:
    """Copy a ``file://`` URL's file to ``dest``; other schemes raise."""
    parsed = urlparse(url)
    if parsed.scheme != "file":
        raise ValueError(f"file_fetcher takes file:// URLs only, got {url}")
    shutil.copyfile(unquote(parsed.path), dest)


_DEFAULT_FETCHER: Optional[Fetcher] = None


def set_default_fetcher(fetcher: Optional[Fetcher]) -> None:
    """Install a process-wide fetcher (None: no downloads)."""
    global _DEFAULT_FETCHER
    _DEFAULT_FETCHER = fetcher


def default_cache_dir() -> str:
    return os.environ.get("QASR_CACHE_DIR", str(Path.home() / ".cache" / "qasr_tpu"))


def maybe_download_from_cloud(url: str, filename: str, *, subfolder: Optional[str] = None,
                              cache_dir: Optional[str] = None, refresh_cache: bool = False,
                              fetcher: Optional[Fetcher] = None,
                              max_attempts: int = 3) -> str:
    """The cached path of ``filename``, fetched from ``url`` on a miss (or
    with ``refresh_cache``) through ``fetcher`` or the default one, up to
    ``max_attempts`` times; the download lands under a temporary name and
    is renamed, so a failed fetch leaves no file.  Raises RuntimeError when
    the file is not cached and cannot be fetched."""
    dest_dir = Path(cache_dir or default_cache_dir())
    if subfolder:
        dest_dir = dest_dir / subfolder
    dest = dest_dir / filename
    if dest.exists():
        if not refresh_cache:
            log.info(f"re-using cached file: {dest}")
            return str(dest)
        log.info(f"refreshing cache: deleting {dest}")
        dest.unlink()
    fetch = fetcher or _DEFAULT_FETCHER
    uri = url + filename if url.endswith("/") else url
    if fetch is None:
        raise RuntimeError(f"{filename} is not cached under {dest_dir} and no fetcher is set "
                           f"(pass fetcher= or call set_default_fetcher)")
    dest_dir.mkdir(parents=True, exist_ok=True)
    last_err: Optional[Exception] = None
    for attempt in range(1, max_attempts + 1):
        tmp = str(dest) + ".part"
        try:
            log.info(f"fetching {uri} -> {dest}")
            fetch(uri, tmp)
            os.replace(tmp, dest)
            return str(dest)
        except Exception as e:
            last_err = e
            if os.path.exists(tmp):
                os.unlink(tmp)
            log.warning(f"fetch failed (attempt {attempt}/{max_attempts}): {e}")
            time.sleep(0.05)
    raise RuntimeError(f"unable to fetch {uri}: {last_err}")


def resolve_pretrained(name: str, *, refresh_cache: bool = False,
                       cache_dir: Optional[str] = None,
                       fetcher: Optional[Fetcher] = None) -> Optional[str]:
    """A card's name -> its cached ``.nemo`` (fetched on a miss), or None
    when no card has the name."""
    card = model_card(name)
    if card is None:
        return None
    key = hashlib.md5((card.location + card.description).encode("utf-8")).hexdigest()
    return maybe_download_from_cloud(card.location, card.location.rsplit("/", 1)[-1],
                                     subfolder=key, cache_dir=cache_dir,
                                     refresh_cache=refresh_cache, fetcher=fetcher)
