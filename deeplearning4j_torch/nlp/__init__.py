"""NLP embeddings (reference ``deeplearning4j-nlp-parent``).

Counterpart of ``deeplearning4j_tpu/nlp/``: the SequenceVectors engine,
Word2Vec/CBOW, ParagraphVectors, GloVe, vocab and Huffman, the tokenization
pipeline, word-vector serialization and the bag-of-words vectorizers. Not
ported yet: ``nlp/lang.py``'s CJK and UIMA tokenizers (``Lexicon``, the
Chinese/Japanese/Korean/UIMA factories, ``AnnotationPipeline``), ROADMAP
A 13b; and ``nlp/distributed.py`` (``DistributedWord2Vec``,
``DistributedGlove``, ``SparkWord2Vec``, ``SparkGlove``,
``partition_sentences``), ROADMAP A 14 with the rest of the parallel layer.
"""
from .text import (SentenceIterator, CollectionSentenceIterator,
                   BasicLineIterator, Tokenizer, TokenizerFactory,
                   DefaultTokenizerFactory, NGramTokenizerFactory,
                   TokenPreProcess, CommonPreprocessor, LowCasePreProcessor,
                   StopWords)
from .vocab import VocabCache, VocabWord, SequenceElement, Huffman, build_vocab
from .sequencevectors import SequenceVectors, InMemoryLookupTable, lookup_table_from_numpy
from .word2vec import Word2Vec, CBOW, ParagraphVectors
from .glove import Glove
from .bagofwords import InvertedIndex, BagOfWordsVectorizer, TfidfVectorizer
from .serializer import WordVectorSerializer, StaticWordVectors

__all__ = ["SentenceIterator", "CollectionSentenceIterator", "BasicLineIterator",
           "Tokenizer", "TokenizerFactory", "DefaultTokenizerFactory",
           "NGramTokenizerFactory", "TokenPreProcess", "CommonPreprocessor",
           "LowCasePreProcessor", "StopWords", "VocabCache", "VocabWord",
           "SequenceElement", "Huffman", "build_vocab", "SequenceVectors",
           "InMemoryLookupTable", "lookup_table_from_numpy", "Word2Vec", "CBOW",
           "ParagraphVectors", "Glove", "InvertedIndex", "BagOfWordsVectorizer",
           "TfidfVectorizer", "WordVectorSerializer", "StaticWordVectors"]
