"""Image generation backends: the execution arm of a decision whose
``image_generation`` plugin is enabled.  Such a decision goes to an image
backend instead of a text model, and the image comes back to the chat
client as a completion whose content embeds it (a markdown image of a
URL or a data URI), so an OpenAI chat client needs nothing new.

- ``OpenAIImageBackend``: ``POST {base_url}/v1/images/generations``;
- ``VLLMOmniBackend``: the chat-completions shape, the image in the
  answer's content parts;
- ``build_backend`` picks one from the plugin's configuration (an
  unknown ``backend`` raises ``ValueError``); ``image_chat_completion``
  wraps a result as a chat completion.

Standard library only (``urllib``, with each backend's timeout).  The
port's copy of the JAX package's ``router/imagegen.py``.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Protocol


@dataclass
class GenerateRequest:
    prompt: str
    negative_prompt: str = ""
    width: int = 1024
    height: int = 1024
    num_inference_steps: int = 0
    guidance_scale: float = 0.0
    seed: Optional[int] = None
    model: str = ""
    quality: str = ""  # openai: standard | hd
    style: str = ""    # openai: vivid | natural


@dataclass
class GenerateResponse:
    image_url: str = ""
    image_base64: str = ""
    revised_prompt: str = ""
    model: str = ""
    backend: str = ""


class Backend(Protocol):
    name: str

    def generate(self, req: GenerateRequest) -> GenerateResponse: ...

    def health_check(self) -> bool: ...


class OpenAIImageBackend:
    """POST {base_url}/v1/images/generations (backend_openai.go)."""

    def __init__(self, base_url: str, api_key: str = "",
                 model: str = "dall-e-3", timeout_s: float = 120.0) -> None:
        self.name = "openai"
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.timeout_s = timeout_s

    def _post(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        req = urllib.request.Request(self.base_url + path,
                                     data=json.dumps(body).encode(),
                                     method="POST")
        req.add_header("content-type", "application/json")
        if self.api_key:
            req.add_header("authorization", f"Bearer {self.api_key}")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def generate(self, req: GenerateRequest) -> GenerateResponse:
        body: Dict[str, Any] = {
            "model": req.model or self.model,
            "prompt": req.prompt,
            "n": 1,
            "size": f"{req.width}x{req.height}",
            "response_format": "b64_json",
        }
        if req.quality:
            body["quality"] = req.quality
        if req.style:
            body["style"] = req.style
        out = self._post("/v1/images/generations", body)
        datum = (out.get("data") or [{}])[0]
        return GenerateResponse(
            image_url=datum.get("url", ""),
            image_base64=datum.get("b64_json", ""),
            revised_prompt=datum.get("revised_prompt", ""),
            model=body["model"], backend=self.name)

    def health_check(self) -> bool:
        try:
            urllib.request.urlopen(self.base_url + "/health",
                                   timeout=5).read()
            return True
        except Exception:
            return False


class VLLMOmniBackend:
    """vLLM-Omni image generation via the chat-completions shape: the
    model answers with image output in message content
    (backend_vllm_omni.go)."""

    def __init__(self, base_url: str, model: str = "",
                 timeout_s: float = 300.0) -> None:
        self.name = "vllm_omni"
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout_s = timeout_s

    def generate(self, req: GenerateRequest) -> GenerateResponse:
        body: Dict[str, Any] = {
            "model": req.model or self.model,
            "messages": [{"role": "user", "content": req.prompt}],
        }
        extra = {}
        if req.width and req.height:
            extra["size"] = f"{req.width}x{req.height}"
        if req.num_inference_steps:
            extra["num_inference_steps"] = req.num_inference_steps
        if req.guidance_scale:
            extra["guidance_scale"] = req.guidance_scale
        if req.seed is not None:
            extra["seed"] = req.seed
        if req.negative_prompt:
            extra["negative_prompt"] = req.negative_prompt
        if extra:
            body["extra_body"] = extra
        hr = urllib.request.Request(
            self.base_url + "/v1/chat/completions",
            data=json.dumps(body).encode(), method="POST")
        hr.add_header("content-type", "application/json")
        with urllib.request.urlopen(hr, timeout=self.timeout_s) as resp:
            out = json.loads(resp.read())
        msg = (out.get("choices") or [{}])[0].get("message", {})
        content = msg.get("content")
        image_url = ""
        image_b64 = ""
        if isinstance(content, list):  # multimodal content parts
            for part in content:
                if part.get("type") == "image_url":
                    image_url = (part.get("image_url") or {}).get("url", "")
                elif part.get("type") == "image":
                    image_b64 = part.get("data", "")
        elif isinstance(content, str) and content.startswith("data:image"):
            image_url = content
        return GenerateResponse(image_url=image_url,
                                image_base64=image_b64,
                                model=out.get("model", body["model"]),
                                backend=self.name)

    def health_check(self) -> bool:
        try:
            urllib.request.urlopen(self.base_url + "/health",
                                   timeout=5).read()
            return True
        except Exception:
            return False


_BACKENDS = {
    "openai": lambda conf: OpenAIImageBackend(
        conf.get("base_url", ""), api_key=conf.get("api_key", ""),
        model=conf.get("model", "dall-e-3"),
        timeout_s=float(conf.get("timeout_s", 120.0))),
    "vllm_omni": lambda conf: VLLMOmniBackend(
        conf.get("base_url", ""), model=conf.get("model", ""),
        timeout_s=float(conf.get("timeout_s", 300.0))),
}


def build_backend(conf: Dict[str, Any]) -> Backend:
    """Factory (imagegen.NewFactory role)."""
    kind = str(conf.get("backend", "openai"))
    if kind not in _BACKENDS:
        raise ValueError(f"unknown imagegen backend {kind!r} "
                         f"(known: {sorted(_BACKENDS)})")
    return _BACKENDS[kind](conf)


def image_chat_completion(resp: GenerateResponse,
                          prompt: str) -> Dict[str, Any]:
    """Wrap a generated image as a chat completion (the reference returns
    images to chat clients as markdown content)."""
    if resp.image_url:
        src = resp.image_url
    elif resp.image_base64:
        src = f"data:image/png;base64,{resp.image_base64}"
    else:
        src = ""
    content = f"![{resp.revised_prompt or prompt}]({src})" if src else \
        "image generation returned no image"
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": resp.model or "image",
        "choices": [{"index": 0,
                     "message": {"role": "assistant", "content": content},
                     "finish_reason": "stop"}],
        "usage": {"prompt_tokens": 0, "completion_tokens": 0,
                  "total_tokens": 0},
        "vsr_annotations": {"image_backend": resp.backend,
                            "revised_prompt": resp.revised_prompt},
    }
