"""The port's ExtProc filter outside the test process: the
``serve-extproc`` subcommand (``python -m semantic_router_tpu_torch
serve-extproc --config <fixture> --device cpu --port 0``) prints its
address on stderr and answers one stream over gRPC, and without
``--device cpu`` and without a GPU exits non-zero; and
``semantic_router_tpu_torch.extproc`` imports and answers a stream
through ``ExtProcService`` in a process where ``grpc`` cannot be
imported, while ``ExtProcServer`` raises ``ImportError`` there."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from semantic_router_tpu_torch.extproc import SERVICE_NAME
from semantic_router_tpu_torch.extproc import external_processor_pb2 as pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "router_config.yaml")


def _headers_msg():
    return pb.ProcessingRequest(request_headers=pb.HttpHeaders(
        headers=pb.HeaderMap(headers=[
            pb.HeaderValue(key=":path", raw_value=b"/v1/chat/completions"),
            pb.HeaderValue(key="content-type",
                           raw_value=b"application/json")])))


def _body_msg(text):
    body = {"model": "auto", "messages": [{"role": "user", "content": text}]}
    return pb.ProcessingRequest(request_body=pb.HttpBody(
        body=json.dumps(body).encode(), end_of_stream=True))


# ---------------------------------------------------------------------------
# without grpc

def test_service_imports_and_answers_without_grpc():
    code = (
        "import json, sys\n"
        "sys.modules['grpc'] = None\n"
        "import semantic_router_tpu_torch.extproc as e\n"
        "from semantic_router_tpu_torch.extproc import "
        "external_processor_pb2 as pb\n"
        "from semantic_router_tpu_torch.config import load_config\n"
        "from semantic_router_tpu_torch.router import Router\n"
        "svc = e.ExtProcService(Router(load_config("
        "'tests/fixtures/router_config.yaml')))\n"
        "body = json.dumps({'model': 'auto', 'messages': [{'role': 'user',"
        " 'content': 'this is urgent, fix asap'}]}).encode()\n"
        "out = list(svc.Process(iter([pb.ProcessingRequest("
        "request_headers=pb.HttpHeaders()), pb.ProcessingRequest("
        "request_body=pb.HttpBody(body=body, end_of_stream=True))]), None))\n"
        "print(json.loads(out[1].request_body.response.body_mutation.body)"
        "['model'])\n"
        "try:\n"
        "    e.ExtProcServer(svc.router)\n"
        "except ImportError:\n"
        "    print('no grpc')\n"
        "svc.close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'semantic_router_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["qwen3-8b", "no", "grpc"]


# ---------------------------------------------------------------------------
# the command line

def _start_cli(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "semantic_router_tpu_torch", "serve-extproc",
         "--config", FIXTURE, "--port", "0"] + args,
        cwd=REPO, env=env, stderr=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)


def test_cli_serve_extproc_answers_a_stream():
    import grpc

    proc = _start_cli(["--device", "cpu"])
    try:
        addr = None
        deadline = time.time() + 120
        for line in proc.stderr:
            if "extproc listening on" in line:
                addr = line.strip().rsplit(" ", 1)[1]
                break
            assert time.time() < deadline
        assert addr and addr.startswith("127.0.0.1:")
        channel = grpc.insecure_channel(addr)
        call = channel.stream_stream(
            f"/{SERVICE_NAME}/Process",
            request_serializer=pb.ProcessingRequest.SerializeToString,
            response_deserializer=pb.ProcessingResponse.FromString)
        try:
            resps = list(call(iter([_headers_msg(),
                                    _body_msg("this is urgent, fix asap")])))
        finally:
            channel.close()
        assert json.loads(resps[1].request_body.response.body_mutation
                          .body)["model"] == "qwen3-8b"
    finally:
        proc.kill()
        proc.wait(30)
        proc.stderr.close()
        proc.stdout.close()


def test_cli_serve_extproc_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device serves")
    proc = _start_cli([])
    try:
        _out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode != 0
    assert "no CUDA device" in err
    assert "extproc listening" not in err
