"""DeepSeek chat template.

A copy of `plangen_tpu/text/chat_template.py` (the port imports nothing of the
JAX package); tests/test_torch_copies.py holds the two equal.

Behavior-compatible with the reference's `Conversation` in
three_party/Janus/janus/utils/conversation.py (template "deepseek",
registered at conversation.py:295-311; DeepSeek sep-style rendering at
conversation.py:80-91) and `apply_sft_template_for_multi_turn_prompts`
(janus/models/processing_vlm.py:137-177):

  * roles "<|User|>" / "<|Assistant|>", separators ["\\n\\n", EOS]
  * each message is rendered `role + ": " + content + sep[i % 2]`;
    an empty message renders as just `role + ":"` (generation prompt)
  * message contents are `.strip()`ed; the final prompt is `.strip()`ed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

USER = "<|User|>"
ASSISTANT = "<|Assistant|>"
EOS_TEXT = "<｜end▁of▁sentence｜>"


@dataclass(frozen=True)
class Message:
    role: str
    content: str


@dataclass(frozen=True)
class DeepSeekTemplate:
    sep: str = "\n\n"
    sep2: str = EOS_TEXT
    system_message: str = ""

    def render(self, messages: Sequence[Message]) -> str:
        seps = (self.sep, self.sep2)
        ret = self.system_message + seps[0] if self.system_message else ""
        for i, msg in enumerate(messages):
            content = msg.content.strip()
            if content:
                ret += f"{msg.role}: {content}{seps[i % 2]}"
            else:
                ret += f"{msg.role}:"
        return ret.strip()

    # -- PlanGen prompt wrappers (reference: plangen_base.py:210-291) --------

    def t2i_prompt(self, caption: str, image_start_tag: str) -> str:
        """Text-to-image prompt: user caption, empty assistant, then <begin_of_image>.

        Reference: wrap_t2i_prompt, plangen_base.py:210-230.
        """
        text = self.render([Message(USER, caption), Message(ASSISTANT, "")])
        return text + image_start_tag

    def uni_prompt(
        self,
        caption: str,
        grounding: str,
        image_start_tag: Optional[str],
    ) -> str:
        """Layout-conditioned prompt: assistant turn holds the grounding string.

        With `image_start_tag=None` this is the stage-1 (layout planning) text;
        the caller must additionally drop the trailing EOS *token* after
        encoding (reference: wrap_uni_prompt in_stage1, plangen_base.py:255-260).
        """
        text = self.render([Message(USER, caption), Message(ASSISTANT, grounding)])
        if image_start_tag is None:
            return text
        return text + image_start_tag

    def mmu_prompt(self, question: str, answer: str, image_tag: str) -> str:
        """Understanding prompt: `<image_placeholder>\\n{question}` user turn.

        Unlike the uni/t2i wrappers (which pass system_prompt="",
        plangen_base.py:224,247), the mmu path goes through the processor's
        `process_one`, which renders with the processor's DEFAULT system
        prompt (processing_vlm.py:292-295 -> system_prompt class attribute at
        :127-132) — so the system message is part of every MMU prompt.
        Found by token-diffing against the actual reference via
        tools/capture_reference.py.

        Reference: wrap_mmu_prompt / mmu_collate, plangen_base.py:263-291,819-840.
        """
        sys_tpl = self if self.system_message else DeepSeekTemplate(
            sep=self.sep, sep2=self.sep2, system_message=MMU_SYSTEM_PROMPT
        )
        return sys_tpl.render(
            [Message(USER, f"{image_tag}\n{question}"), Message(ASSISTANT, answer)]
        )


MMU_QUESTION = (
    "Please describe this image and then give the description and bounding box "
    "of each object in the image."
)  # reference: plangen_base.py:823

MMU_SYSTEM_PROMPT = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)  # reference: VLChatProcessor.system_prompt, processing_vlm.py:127-132
