from .tokenizer import ClipBpeTokenizer, tokenize

__all__ = ["ClipBpeTokenizer", "tokenize"]
