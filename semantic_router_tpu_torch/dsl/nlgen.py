"""Natural-language instructions to routing DSL: an LLM (any
``callable(prompt) -> str``) writes a program from a prompt holding the
DSL's reference and an example; the answer is stripped of fences and
prose (``sanitize_llm_output``) and must compile (``compiler.
compile_dsl``, syntax and semantic checks) before it is returned; a
compile error goes back to the LLM in a repair prompt, at most
``max_retries`` times.  ``repair_from_feedback`` starts from a rejected
program.  The prompts are the reference package's, word for word.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..config.schema import RouterConfig
from .compiler import compile_dsl

SCHEMA_REFERENCE = '''
The routing DSL:

model "<name>" { param_size: "8B" quality_score: 0.9
                 loras: [{ name: "adapter" }] }

signal keyword <name> { method: ngram|bm25|exact|fuzzy
                        keywords: ["w1", "w2"] ngram_threshold: 0.4 }
signal domain <name-or-"quoted name">
signal complexity <name> { threshold: 0.6
    hard: { candidates: ["solve step by step"] }
    easy: { candidates: ["answer briefly"] } }
signal authz <name> { role: <role> subjects: [{ kind: Group name: g }] }

decision <name> priority <int> {
    when <expr>        # and / or / not over family(<rule>) references
    route to "<model>" [weight <float>] [reasoning high|low]
                       [lora "<adapter>"]
    algorithm static|elo|confidence|ratings|... { <props> }
    plugin <type> { <props> }   # semantic-cache, system_prompt, pii, ...
}

Rules: the first declared model is the default; every model referenced
by a route must be declared; every signal referenced in when-exprs must
be declared. Output ONLY DSL code, no prose, no markdown fences.
'''

FEW_SHOT = '''
Instruction: route urgent customer messages to the fast 8B model,
everything about law to the 32B model with reasoning.

model "fast-8b" { param_size: "8B" quality_score: 0.8 }
model "big-32b" { param_size: "32B" quality_score: 0.95 }

signal keyword urgent_kw { method: ngram keywords: ["urgent", "asap"]
                           ngram_threshold: 0.4 }
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


@dataclass
class NLResult:
    code: str = ""
    config: Optional[RouterConfig] = None
    valid: bool = False
    attempts: int = 0
    errors: List[str] = field(default_factory=list)


def sanitize_llm_output(text: str) -> str:
    """The largest fenced block of ``text`` (its language tag dropped),
    else the text, stripped."""
    if "```" in text:
        parts = text.split("```")
        blocks = [parts[i] for i in range(1, len(parts), 2)]
        if blocks:
            best = max(blocks, key=len)
            if best.startswith(("dsl", "text", "routing")):
                best = best.split("\n", 1)[1] if "\n" in best else ""
            return best.strip()
    return text.strip()


def build_nl_prompt(instruction: str, task_context: str = "") -> str:
    ctx = f"\nDeployment context:\n{task_context}\n" if task_context else ""
    return (f"You write routing policies in a DSL.\n{SCHEMA_REFERENCE}\n"
            f"Example:\n{FEW_SHOT}\n{ctx}"
            f"Instruction: {instruction}\n\nDSL:\n")


def build_repair_prompt(instruction: str, bad_code: str,
                        feedback: str, task_context: str = "") -> str:
    ctx = f"\nDeployment context:\n{task_context}\n" if task_context else ""
    return (f"You write routing policies in a DSL.\n{SCHEMA_REFERENCE}\n"
            f"{ctx}Instruction: {instruction}\n\n"
            f"This attempt FAILED to compile:\n{bad_code}\n\n"
            f"Compiler error:\n{feedback}\n\n"
            f"Output the corrected DSL only.\n\nDSL:\n")


def _try_compile(code: str) -> tuple[Optional[RouterConfig], str]:
    try:
        return compile_dsl(code), ""
    except Exception as exc:
        return None, f"{type(exc).__name__}: {exc}"


def _run_loop(llm: Callable[[str], str], instruction: str,
              first_prompt: str, max_retries: int,
              task_context: str) -> NLResult:
    """Generate, compile, repair: the loop both entry points share."""
    result = NLResult()
    prompt = first_prompt
    code = ""
    for attempt in range(max_retries + 1):
        result.attempts = attempt + 1
        code = sanitize_llm_output(llm(prompt))
        cfg, err = _try_compile(code)
        if cfg is not None:
            result.code = code
            result.config = cfg
            result.valid = True
            return result
        result.errors.append(err)
        prompt = build_repair_prompt(instruction, code, err, task_context)
    result.code = code
    return result


def generate_from_nl(llm: Callable[[str], str], instruction: str,
                     max_retries: int = 2,
                     task_context: str = "") -> NLResult:
    """A program for ``instruction``, compiled, repaired on failure."""
    return _run_loop(llm, instruction,
                     build_nl_prompt(instruction, task_context),
                     max_retries, task_context)


def repair_from_feedback(llm: Callable[[str], str], instruction: str,
                         bad_code: str, feedback: str,
                         max_retries: int = 2,
                         task_context: str = "") -> NLResult:
    """A repaired ``bad_code`` (a rejected or broken program), given the
    reason in ``feedback``."""
    return _run_loop(llm, instruction,
                     build_repair_prompt(instruction, bad_code, feedback,
                                         task_context),
                     max_retries, task_context)
