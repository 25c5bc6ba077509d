"""Evaluation harness (STI / CP / NT, ACC, BLEU): the port's own copy of the
JAX package's ``evaluate/``, with its own binary unigram vectorizer and L1
logistic regression in place of scikit-learn's (``evaluate/lexicon.py``)."""
