from .evaluate import coco_references, evaluate_captions, run
from .metrics import (bleu, bleu_n, cider_d, ptb_tokenize, rouge_l,
                      simple_tokenize)
