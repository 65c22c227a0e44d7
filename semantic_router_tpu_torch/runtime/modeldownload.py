"""Model download: resolve configured checkpoints before serving.

The port's copy of ``semantic_router_tpu.runtime.modeldownload``
(reference: pkg/modeldownload/downloader.go:13-120): models named in the
config download through the Hugging Face CLI at boot, with progress for
readiness probes, and a gated model skipped softly (a missing token
degrades the router, never crashes it).

Resolution order for each spec:
1. a local path already present (``cache_dir/<repo_id>`` or the literal
   path);
2. ``hf`` / ``huggingface-cli download`` when the CLI exists (absent in a
   zero-egress image; a 401, a gated repo or any failure without a token
   is a soft skip: the task stays unloaded and its signals fail open).

``runtime/bootstrap.py``'s ``build_engine`` runs ``ensure_all`` over the
tasks whose checkpoint is not on disk and emits ``download_started`` /
``download_done`` / ``download_failed`` on the event bus.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..observability.logging import component_event


@dataclass
class ProgressState:
    phase: str = "idle"  # idle | downloading | ready | degraded
    downloading_model: str = ""
    pending_models: List[str] = field(default_factory=list)
    ready_models: int = 0
    total_models: int = 0
    message: str = ""

    def to_dict(self) -> Dict:
        return {"phase": self.phase,
                "downloading_model": self.downloading_model,
                "pending_models": list(self.pending_models),
                "ready_models": self.ready_models,
                "total_models": self.total_models,
                "message": self.message}


def _hf_cli() -> Optional[str]:
    for cmd in ("hf", "huggingface-cli"):
        if shutil.which(cmd):
            return cmd
    return None


def is_gated_error(stderr: str, repo_id: str, token: str) -> bool:
    """Gated/auth failures (and any failure with no token) soft-skip
    instead of failing startup (IsGatedModelError parity)."""
    s = stderr.lower()
    rid = repo_id.lower()
    known_gated = any(g in rid for g in ("gemma", "embeddinggemma"))
    auth = any(m in s for m in ("401", "unauthorized", "gated",
                                "repository not found", "404",
                                "authentication required"))
    return known_gated or auth or not token


class ModelDownloader:
    def __init__(self, cache_dir: str = "",
                 hf_token: str = "",
                 reporter: Optional[Callable[[ProgressState],
                                             None]] = None) -> None:
        self.cache_dir = cache_dir or os.environ.get(
            "SRT_MODEL_CACHE", os.path.expanduser("~/.cache/srt-models"))
        self.hf_token = hf_token or os.environ.get("HF_TOKEN", "")
        self.reporter = reporter
        self.state = ProgressState()
        self._lock = threading.Lock()

    def _report(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self.state, k, v)
            snap = ProgressState(**self.state.to_dict())
        if self.reporter:
            self.reporter(snap)

    def local_path(self, repo_id: str) -> str:
        if os.path.exists(repo_id):  # literal path in config
            return repo_id
        return os.path.join(self.cache_dir, repo_id.replace("/", "__"))

    COMPLETE_SENTINEL = ".srt-complete"

    def is_present(self, repo_id: str) -> bool:
        """A cache entry counts only when COMPLETE: either our sentinel
        (written after a successful download) or actual weight files —
        config.json alone is what an interrupted download leaves behind
        and must trigger a retry, not a permanent broken load."""
        path = self.local_path(repo_id)
        if not os.path.isdir(path):
            return False
        files = os.listdir(path)
        return self.COMPLETE_SENTINEL in files or any(
            f.endswith((".safetensors", ".bin")) for f in files)

    def download(self, repo_id: str) -> Optional[str]:
        """Returns the local path, or None on soft skip."""
        if self.is_present(repo_id):
            return self.local_path(repo_id)
        cli = _hf_cli()
        if cli is None:
            component_event("modeldownload", "cli_missing",
                            repo=repo_id, level="warning")
            return None  # zero-egress image: nothing to do
        target = self.local_path(repo_id)
        os.makedirs(target, exist_ok=True)
        env = dict(os.environ)
        if self.hf_token:
            env["HF_TOKEN"] = self.hf_token
        self._report(phase="downloading", downloading_model=repo_id)
        proc = subprocess.run(
            [cli, "download", repo_id, "--local-dir", target],
            capture_output=True, text=True, env=env)
        if proc.returncode != 0:
            if is_gated_error(proc.stderr, repo_id, self.hf_token):
                component_event("modeldownload", "gated_skip",
                                repo=repo_id, level="warning")
                return None
            raise RuntimeError(
                f"download of {repo_id!r} failed: "
                f"{proc.stderr.strip()[-300:]}")
        with open(os.path.join(target, self.COMPLETE_SENTINEL), "w") as f:
            f.write("ok\n")
        return target

    def ensure_all(self, specs: Dict[str, Dict]) -> Dict[str, str]:
        """Resolve every classifier_models checkpoint; returns
        task → local path for the ones available. Missing models degrade
        (their signals fail open) rather than failing startup."""
        wanted = {task: spec.get("checkpoint", "")
                  for task, spec in (specs or {}).items()
                  if spec.get("checkpoint")}
        self._report(phase="downloading" if wanted else "ready",
                     total_models=len(wanted),
                     pending_models=list(wanted))
        resolved: Dict[str, str] = {}
        for task, repo in wanted.items():
            try:
                path = repo if os.path.exists(repo) else \
                    self.download(repo)
            except RuntimeError as exc:
                component_event("modeldownload", "failed", task=task,
                                error=str(exc), level="warning")
                path = None
            if path:
                resolved[task] = path
            self._report(ready_models=len(resolved),
                         pending_models=[t for t in wanted
                                         if t not in resolved])
        self._report(phase="ready" if len(resolved) == len(wanted)
                     else "degraded", downloading_model="")
        return resolved
