"""Scheduled / alternating prompt grammar ("prompt editing").

Parity target: PromptSequenceTransform
(/root/reference/cpd/embeddings/transforms.py:632-758), i.e. the
AUTOMATIC1111-style syntax:

  * ``[a:b:0.5]`` — render "a" for the first half of the steps, then "b"
    (a bare number >= 1 is an absolute step; < 1 is a fraction of steps)
  * ``[a:10]``    — introduce "a" at step 10; ``[a::10]`` semantics via
    ``[a:b:N]`` with empty parts
  * ``[a|b]``     — alternate between variants every step
  * ``(x:1.2)`` / ``[x]`` — emphasis brackets pass through unchanged here
    (weighting is the embedding layer's job)

The executable spec is the doctest table in the reference
(transforms.py:686-709), reproduced in tests/test_prompts.py.

``expand_schedule(prompt, steps)`` returns ``[[until_step, text], ...]`` —
the prompt text in effect up to (and including) each boundary step.
"""

from __future__ import annotations

import functools
from typing import List

__all__ = ["expand_schedule", "get_prompt_sequence"]

_GRAMMAR = r"""
!start: (prompt | /[][():]/+)*
prompt: (emphasized | scheduled | alternate | plain | WHITESPACE)*
!emphasized: "(" prompt ")"
        | "(" prompt ":" prompt ")"
        | "[" prompt "]"
scheduled: "[" [prompt ":"] prompt ":" [WHITESPACE] NUMBER "]"
alternate: "[" prompt ("|" prompt)+ "]"
WHITESPACE: /\s+/
plain: /([^\\\[\]():|]|\\.)+/
%import common.SIGNED_NUMBER -> NUMBER
"""


def _lark():
    """The ``lark`` package, imported on first use: only this grammar needs
    it (install the ``schedule`` extra)."""
    try:
        import lark
    except ImportError as e:
        raise ImportError(
            "scheduled prompts ('[a:b:0.5]', '[a|b]') need the 'lark' "
            "package: pip install 'complex-prompt-diffusion-tpu[schedule]'"
        ) from e
    return lark


@functools.lru_cache(maxsize=1)
def _parser():
    return _lark().Lark(_GRAMMAR)


def _boundaries(tree, steps: int) -> List[int]:
    """All step indices at which the rendered text changes."""
    found = [steps]

    class Collect(_lark().Visitor):
        def scheduled(self, t):
            when = float(t.children[-1])
            if when < 1:
                when *= steps
            t.children[-1] = min(steps, int(when))
            found.append(t.children[-1])

        def alternate(self, t):
            found.extend(range(1, steps + 1))

    Collect().visit(tree)
    return sorted(set(found))


def _render_at(tree, step: int) -> str:
    class Render(_lark().Transformer):
        def scheduled(self, args):
            before, after, _ws, when = args
            yield (before or ()) if step <= when else after

        def alternate(self, args):
            yield next(args[(step - 1) % len(args)])

        def start(self, args):
            def flatten(x):
                if isinstance(x, str):
                    yield x
                else:
                    for item in x:
                        yield from flatten(item)

            return "".join(flatten(args))

        def plain(self, args):
            yield args[0].value

        def __default__(self, data, children, meta):
            for child in children:
                yield from child

    return Render().transform(tree)


def expand_schedule(prompt: str, steps: int) -> List[List]:
    """One prompt -> [[until_step, text], ...]. Unparsable input (e.g.
    unbalanced brackets) degrades to a single constant entry, like the
    reference (transforms.py:749-753)."""
    try:
        tree = _parser().parse(prompt)
    except _lark().exceptions.LarkError:
        return [[steps, prompt]]
    return [[t, _render_at(tree, t)] for t in _boundaries(tree, steps)]


def get_prompt_sequence(prompts: List[str], steps: int) -> List[List[List]]:
    """Batch version over a list of prompts (memoized per unique prompt),
    matching get_prompt_sequence (transforms.py:684-758)."""
    cache = {p: expand_schedule(p, steps) for p in set(prompts)}
    return [cache[p] for p in prompts]
