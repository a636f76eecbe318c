"""BLEU score. Port of ``metrics_tpu/functional/nlp.py``.

The n-gram counts are host-side Python over tokenized strings (counting
strings is not tensor work); the final arithmetic is float32, as in the
JAX package, and the result is a 0-d tensor on the device the metrics
default to: the GPU unless the caller names another.
"""
from collections import Counter
from typing import List, Optional, Sequence, Union

import torch

from metrics_tpu_torch.metric import _resolve_device


def _count_ngram(ngram_input_list: List[str], n_gram: int) -> Counter:
    """Count every 1..n-gram occurrence in a token list."""
    ngram_counter: Counter = Counter()

    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_key = tuple(ngram_input_list[j:(i + j)])
            ngram_counter[ngram_key] += 1

    return ngram_counter


def bleu_score(
    translate_corpus: Sequence[Sequence[str]],
    reference_corpus: Sequence[Sequence[Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Calculate BLEU score of machine-translated text with one or more references.

    Args:
        translate_corpus: An iterable of machine translated corpus
        reference_corpus: An iterable of iterables of reference corpus
        n_gram: Gram value ranged from 1 to 4 (Default 4)
        smooth: Whether or not to apply smoothing - Lin et al. 2004
        device: where the result lives; None means the GPU, as for the
            metrics (raises without one: pass ``device="cpu"``)

    Example:
        >>> translate_corpus = ['the cat is on the mat'.split()]
        >>> reference_corpus = [['there is a cat on the mat'.split(), 'a cat is on the mat'.split()]]
        >>> bleu_score(translate_corpus, reference_corpus, device="cpu")
        tensor(0.7598)
    """
    device = _resolve_device(device)
    assert len(translate_corpus) == len(reference_corpus)
    numerator = [0.0] * n_gram
    denominator = [0.0] * n_gram
    c = 0.0
    r = 0.0

    for translation, references in zip(translate_corpus, reference_corpus):
        c += len(translation)
        # closest reference length (ties go to the first/shorter)
        ref_len_list = [len(ref) for ref in references]
        ref_len_diff = [abs(len(translation) - x) for x in ref_len_list]
        r += ref_len_list[ref_len_diff.index(min(ref_len_diff))]
        translation_counter = _count_ngram(list(translation), n_gram)
        reference_counter: Counter = Counter()

        for ref in references:
            reference_counter |= _count_ngram(list(ref), n_gram)

        # clipped counts: per n-gram, no more credit than the best reference
        ngram_counter_clip = translation_counter & reference_counter

        for counter_clip in ngram_counter_clip:
            numerator[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]

        for counter in translation_counter:
            denominator[len(counter) - 1] += translation_counter[counter]

    if min(numerator) == 0.0:
        return torch.zeros((), dtype=torch.float32, device=device)

    # float32 on the host, as the JAX package computes it; one copy to the device
    num = torch.tensor(numerator, dtype=torch.float32)
    denom = torch.tensor(denominator, dtype=torch.float32)
    if smooth:
        # add-1 smoothing on every order, unigram included, as the JAX
        # package (and its reference) smooth
        precision_scores = (num + 1.0) / (denom + 1.0)
    else:
        precision_scores = num / denom

    geometric_mean = torch.exp(torch.sum(torch.log(precision_scores) / n_gram))
    brevity_penalty = torch.tensor(1.0) if c > r else torch.exp(1 - torch.tensor(r / c, dtype=torch.float32))
    return (brevity_penalty * geometric_mean).to(device=device, dtype=torch.float32)
