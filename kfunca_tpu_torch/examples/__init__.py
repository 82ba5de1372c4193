"""The runnable examples, one module for each script of the JAX package's
examples/ under the same name, each run as

    python -m kfunca_tpu_torch.examples.<name> [flags] [--device cpu]

Each takes its JAX counterpart's flags and defaults plus --device (the
card by default; `--device cpu` runs the plain PyTorch path), and applies
its outcome check in main(argv), exiting non-zero (SystemExit) when the
check fails.  run(args) does the work and returns what the example checks.

  serve_lm            InferenceServer burst, per-request sampling overrides
  train_lm            TokenDataset + Prefetcher, train step, checkpoint, generate
  speculative_lm      speculative_generate token-exact against generate
  serve_hf            from_hf (a hermetic tiny Llama or --model DIR), w8kv8, --tp
  serve_api           ApiServer over a BPE tokenizer (or --hf DIR)
  finetune_e2e        tokenizer -> data -> optimizer zoo + EMA -> serve -> beam
  align_lora_dpo      LoRA SFT -> LoRA-DPO -> multi-LoRA serving
  rl_grpo             GRPO rollouts, rewards and steps
  serve_deepseek      a hermetic tiny DeepSeek-V3, MLAServer against generate
  zb_pipeline         the zero-bubble schedule and step over a 4-stage mesh
  seq2seq_t5          T5 learns to sort (>= 90% exact match)
  asr_whisper         Whisper transcribes tones (>= 90% exact match)
  caption_multimodal  the ViT-prefix LM captions quadrants (>= 90%)
  generate_dit        DiT samples reproduce the training pattern
"""

NAMES = ("serve_lm", "train_lm", "speculative_lm", "serve_hf", "serve_api",
         "finetune_e2e", "align_lora_dpo", "rl_grpo", "serve_deepseek",
         "zb_pipeline", "seq2seq_t5", "asr_whisper", "caption_multimodal",
         "generate_dit")
