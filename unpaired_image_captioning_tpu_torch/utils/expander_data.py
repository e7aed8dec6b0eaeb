"""The port's copy of `unpaired_image_captioning_tpu/utils/expander_data.py`,
GENERATED there by tools/distill_expander.py — do not edit.

Pooled argmax of the reference expander's statistical
disambiguation tables (misc/expander/disambiguations.yaml +
disambiguations_4tags.yaml): (prev_word, contraction_suffix) ->
most likely expansion, POS contexts marginalized out (the rebuild
has no runtime POS tagger). Pinned by tests/test_expander.py.
"""

PAIR_DEFAULT = {
    ('<ne>', "'d"): '<NE> had',
    ('<ne>', "'ll"): '<NE> will',
    ('<ne>', "'s"): '<NE> is',
    ('ain', "'t"): 'is not',
    ('he', "'d"): 'he had',
    ('he', "'ll"): 'he will',
    ('he', "'s"): 'he is',
    ('how', "'s"): 'how is',
    ('i', "'d"): 'I had',
    ('i', "'ll"): 'I will',
    ('it', "'d"): 'it had',
    ('it', "'ll"): 'it will',
    ('it', "'s"): 'it is',
    ('she', "'d"): 'she had',
    ('she', "'ll"): 'she will',
    ('she', "'s"): 'she is',
    ('so', "'s"): 'so as',
    ('that', "'d"): 'that had',
    ('that', "'s"): 'that is',
    ('there', "'d"): 'there had',
    ('there', "'s"): 'there is',
    ('they', "'d"): 'they had',
    ('they', "'ll"): 'they will',
    ('we', "'d"): 'we had',
    ('what', "'ll"): 'what will',
    ('what', "'s"): 'what is',
    ('when', "'s"): 'when is',
    ('where', "'s"): 'where is',
    ('who', "'ll"): 'who will',
    ('who', "'s"): 'who is',
    ('why', "'s"): 'why is',
    ('you', "'d"): 'you would',
    ('you', "'ll"): 'you will',
}
