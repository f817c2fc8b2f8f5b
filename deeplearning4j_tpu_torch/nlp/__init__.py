"""NLP / embeddings: word2vec, SequenceVectors, ParagraphVectors, GloVe,
tokenization and the text pipeline under them.

Port of ``deeplearning4j_tpu/nlp`` (the embeddings half). The host builds
batches of (center, context, negative) index arrays, or the fused path
draws a whole epoch's plan on the device; one step per batch gathers the
embedding rows, computes the skip-gram/CBOW/HS objective and adds the
updates back with fixed-order scatter-adds.

Not here yet: the tree and tagging side (``Tree``, ``TreebankParser``,
``HmmPosTagger``, ``Viterbi``, ``InvertedIndex``, ``SWN3``, the bag of
words; ROADMAP A13.2). ``DistributedWord2Vec`` raises (ROADMAP A14).
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (  # noqa: F401
    BasicLineIterator,
    CollectionSentenceIterator,
    FileSentenceIterator,
    LineSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    Huffman,
    VocabCache,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.epoch_kernels import (  # noqa: F401
    SkipGramCorpusCache,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import (  # noqa: F401
    SequenceVectors,
)
from deeplearning4j_tpu_torch.nlp.distributed import (  # noqa: F401
    DistributedWord2Vec,
)
from deeplearning4j_tpu_torch.nlp.word2vec_iterator import (  # noqa: F401
    Word2VecDataSetIterator,
)
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.nlp.movingwindow import (  # noqa: F401
    Window,
    moving_window_matrix,
    window_indices,
    windows,
)
from deeplearning4j_tpu_torch.nlp.stopwords import (  # noqa: F401
    get_stop_words,
    is_stop_word,
    remove_stop_words,
)
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (  # noqa: F401
    ParagraphVectors,
)
