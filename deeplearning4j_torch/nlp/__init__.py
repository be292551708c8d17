"""NLP embeddings (reference ``deeplearning4j-nlp-parent``).

Counterpart of ``deeplearning4j_tpu/nlp/``: the SequenceVectors engine,
Word2Vec/CBOW, ParagraphVectors, GloVe, vocab and Huffman, the tokenization
pipeline, word-vector serialization, the bag-of-words vectorizers, the
CJK and UIMA language modules (``lang.py``) and Word2Vec and GloVe across
processes (``distributed.py``).
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
from .lang import (Lexicon,
                   ChineseTokenizerFactory, JapaneseTokenizerFactory,
                   KoreanTokenizerFactory, UimaTokenizerFactory,
                   AnnotationPipeline)
from .distributed import (DistributedWord2Vec, DistributedGlove, SparkWord2Vec, SparkGlove,
                          partition_sentences)

__all__ = ["SentenceIterator", "CollectionSentenceIterator", "BasicLineIterator",
           "Tokenizer", "TokenizerFactory", "DefaultTokenizerFactory",
           "NGramTokenizerFactory", "TokenPreProcess", "CommonPreprocessor",
           "LowCasePreProcessor", "StopWords", "VocabCache", "VocabWord",
           "SequenceElement", "Huffman", "build_vocab", "SequenceVectors",
           "InMemoryLookupTable", "lookup_table_from_numpy", "Word2Vec", "CBOW",
           "ParagraphVectors", "Glove", "InvertedIndex", "BagOfWordsVectorizer",
           "TfidfVectorizer", "WordVectorSerializer", "StaticWordVectors",
           "Lexicon", "ChineseTokenizerFactory", "JapaneseTokenizerFactory",
           "KoreanTokenizerFactory", "UimaTokenizerFactory", "AnnotationPipeline",
           "DistributedWord2Vec", "DistributedGlove", "SparkWord2Vec", "SparkGlove",
           "partition_sentences"]
