from sqlrs_tpu_torch.parser.parser import parse, parse_one
from sqlrs_tpu_torch.parser import ast

__all__ = ["parse", "parse_one", "ast"]
