from raven_tpu_torch.io.fastx import ParserError, load_sequences, parse_file  # noqa: F401
from raven_tpu_torch.io.readset import (  # noqa: F401
    ReadSet,
    decode,
    encode,
    reverse_complement,
)
