from .tokenizer import tokenize_ja, tokenize_ja_bulk  # noqa: F401
