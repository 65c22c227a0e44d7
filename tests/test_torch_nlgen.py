"""NL → DSL generation in the port against the JAX package, on the CPU:
the same scripted LLM (its answers seeded, good, fenced, broken and
repaired) through both packages' ``generate_from_nl`` and
``repair_from_feedback`` sends the same prompts, and gets the same
result: validity, attempts, errors, code, and a config that parses to
the reference's decisions and models; ``sanitize_llm_output`` and both
prompt builders equal the reference's."""

import random

import pytest

from semantic_router_tpu.dsl import nlgen as jnl
from semantic_router_tpu_torch.dsl import nlgen as tnl

GOOD_DSL = '''
model "fast-8b" { param_size: "8B" quality_score: 0.8 }
model "big-32b" { param_size: "32B" quality_score: 0.95 }
signal keyword urgent_kw { method: exact keywords: ["urgent", "asap"] }
signal domain law
decision urgent_route priority 200 {
    when keyword(urgent_kw)
    route to "fast-8b"
    algorithm static
}
decision law_route priority 100 {
    when domain(law)
    route to "big-32b" reasoning high
    algorithm static
}
'''
BROKEN = ['decision d priority 10 { when kw route to "ghost" '
          'algorithm static }',
          "not dsl at all {",
          'model "m" { param_size: "8B" }\ndecision x priority 1 { '
          'when keyword(nope) route to "m" }']
ANSWERS = [GOOD_DSL, f"```dsl\n{GOOD_DSL}```", f"Sure:\n```\n{GOOD_DSL}\n"
           "```\nEnjoy."] + BROKEN


def _script(seed):
    """A seeded LLM answer sequence and a recorder of the prompts it
    saw."""
    rng = random.Random(seed)
    answers = [rng.choice(ANSWERS) for _ in range(4)]
    prompts = []

    def llm(prompt):
        prompts.append(prompt)
        return answers[min(len(prompts) - 1, len(answers) - 1)]

    return llm, prompts


def _outcome(res):
    cfg = res.config
    return (res.valid, res.attempts, res.errors, res.code,
            None if cfg is None else (
                [(d.name, d.priority, [m.model for m in d.model_refs])
                 for d in cfg.decisions],
                [m.name for m in cfg.model_cards]))


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("retries", [0, 2])
def test_generate_and_repair_equal_the_reference(seed, retries):
    for fn, args in (("generate_from_nl", ("route urgent to fast-8b",)),
                     ("repair_from_feedback",
                      ("route urgent", "decision broken {",
                       "unbalanced brace"))):
        jllm, jprompts = _script(seed)
        tllm, tprompts = _script(seed)
        want = getattr(jnl, fn)(jllm, *args, max_retries=retries,
                                task_context="ctx" if seed % 2 else "")
        got = getattr(tnl, fn)(tllm, *args, max_retries=retries,
                               task_context="ctx" if seed % 2 else "")
        assert tprompts == jprompts
        assert _outcome(got) == _outcome(want)


@pytest.mark.parametrize("text", ANSWERS + [
    "  plain text ", "```\nonly fence", "``` a ``` b ```longer block```",
    "```routing\nx\n```", "```text```"])
def test_sanitize_and_prompts_equal_the_reference(text):
    assert tnl.sanitize_llm_output(text) == jnl.sanitize_llm_output(text)
    assert tnl.build_nl_prompt(text, "ctx") == jnl.build_nl_prompt(text,
                                                                   "ctx")
    assert tnl.build_repair_prompt("i", text, "err") \
        == jnl.build_repair_prompt("i", text, "err")
    assert tnl.SCHEMA_REFERENCE == jnl.SCHEMA_REFERENCE
    assert tnl.FEW_SHOT == jnl.FEW_SHOT
