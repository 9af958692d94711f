// globalign_jax native host runtime.
//
// The device owns the O(m*n) fill (JAX/XLA); this library owns the host-side
// serial work around it, replacing the interpreted-Python equivalents:
//
//   * FASTA streaming parser (reference: src/globalign/start.py:614-688) —
//     byte-level scan, no per-line Python objects, handles multi-GB files.
//   * Traceback walker (reference: src/globalign/globaligner.py:395-753) —
//     the O(m+n) predecessor walk over packed move codes; branchy scalar
//     code that is pointer-chasing in C instead of interpreter dispatch.
//   * Length bucketizer for the batched pair engine.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image);
// every entry point has a pure-Python fallback with identical semantics
// (globalign_jax/utils/fasta.py, ops/traceback.py), asserted equal by
// tests/test_native.py.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// FASTA parsing
// ---------------------------------------------------------------------------

// Parsed FASTA file: flattened records (descriptions and sequences are
// concatenated; offsets delimit each record).
struct GaFasta {
  char* desc;          // concatenated descriptions
  int64_t* desc_off;   // n_records + 1 offsets into desc
  char* seq;           // concatenated upper-cased sequences
  int64_t* seq_off;    // n_records + 1 offsets into seq
  int64_t n_records;
  char err[256];       // empty on success
};

static void ga_set_err(GaFasta* out, const char* msg) {
  std::snprintf(out->err, sizeof(out->err), "%s", msg);
}

// Parse a FASTA file per the NCBI shape the reference accepts
// (start.py:614-663): records start with '>' description lines; sequence
// data may span lines and is upper-cased; an empty sequence or leading
// garbage before the first '>' is an error.
GaFasta* ga_fasta_parse(const char* path) {
  GaFasta* out = static_cast<GaFasta*>(std::calloc(1, sizeof(GaFasta)));
  if (!out) return nullptr;

  FILE* f = std::fopen(path, "rb");
  if (!f) {
    ga_set_err(out, "cannot open file");
    return out;
  }

  std::string desc, seq;
  std::vector<int64_t> desc_off{0}, seq_off{0};
  bool in_record = false;
  bool line_start = true;
  bool in_desc = false;
  bool prev_seq_empty = false;

  std::vector<char> buf(1 << 20);
  size_t got;
  while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t k = 0; k < got; ++k) {
      char c = buf[k];
      if (c == '\r') continue;
      if (c == '\n') {
        line_start = true;
        in_desc = false;
        continue;
      }
      if (line_start && c == '>') {
        if (in_record) {
          if (seq.size() == static_cast<size_t>(seq_off.back())) {
            prev_seq_empty = true;
          }
          desc_off.push_back(static_cast<int64_t>(desc.size()));
          seq_off.push_back(static_cast<int64_t>(seq.size()));
        }
        in_record = true;
        in_desc = true;
        line_start = false;
        continue;
      }
      line_start = false;
      if (!in_record) {
        std::fclose(f);
        ga_set_err(out,
                   "The first line of the FASTA file did not begin with >");
        return out;
      }
      if (in_desc) {
        desc.push_back(c);
      } else if (!std::isspace(static_cast<unsigned char>(c))) {
        seq.push_back(static_cast<char>(
            std::toupper(static_cast<unsigned char>(c))));
      }
    }
  }
  std::fclose(f);

  if (in_record) {
    if (seq.size() == static_cast<size_t>(seq_off.back())) {
      prev_seq_empty = true;
    }
    desc_off.push_back(static_cast<int64_t>(desc.size()));
    seq_off.push_back(static_cast<int64_t>(seq.size()));
  }
  if (prev_seq_empty) {
    ga_set_err(out, "A sequence in the FASTA file was empty.");
    return out;
  }
  if (!in_record) {
    ga_set_err(out, "The FASTA file contained no records.");
    return out;
  }

  out->n_records = static_cast<int64_t>(desc_off.size()) - 1;
  out->desc = static_cast<char*>(std::malloc(desc.size() + 1));
  std::memcpy(out->desc, desc.data(), desc.size());
  out->desc[desc.size()] = 0;
  out->seq = static_cast<char*>(std::malloc(seq.size() + 1));
  std::memcpy(out->seq, seq.data(), seq.size());
  out->seq[seq.size()] = 0;
  out->desc_off = static_cast<int64_t*>(
      std::malloc(desc_off.size() * sizeof(int64_t)));
  std::memcpy(out->desc_off, desc_off.data(),
              desc_off.size() * sizeof(int64_t));
  out->seq_off = static_cast<int64_t*>(
      std::malloc(seq_off.size() * sizeof(int64_t)));
  std::memcpy(out->seq_off, seq_off.data(), seq_off.size() * sizeof(int64_t));
  return out;
}

void ga_fasta_free(GaFasta* p) {
  if (!p) return;
  std::free(p->desc);
  std::free(p->desc_off);
  std::free(p->seq);
  std::free(p->seq_off);
  std::free(p);
}

// ---------------------------------------------------------------------------
// Tokenization
// ---------------------------------------------------------------------------

// Tokenize seq (len chars) into a 1-origin int32 buffer out[len+1] using a
// 256-entry char->id map (-1 = invalid).  Returns index of first invalid
// char, or -1 on success.  out[0] = 0 (dummy; matches
// utils/tokenize.encode_padded).
int64_t ga_tokenize(const char* seq, int64_t len, const int32_t* char_map,
                    int32_t* out) {
  out[0] = 0;
  for (int64_t i = 0; i < len; ++i) {
    int32_t id = char_map[static_cast<unsigned char>(seq[i])];
    if (id < 0) return i;
    out[i + 1] = id;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Traceback walk
// ---------------------------------------------------------------------------

// Walk row-major packed move codes from (m, n) back to (0, 0), mirroring
// ops/traceback.py::traceback_moves(layout="row") exactly: codes pack the
// argmin provenance per level (bits 0-1 = M, 2-3 = Ix, 4-5 = Iy); tie order
// M > Ix > Iy; row-0/column-0 boundary shortcuts (reference
// globaligner.py:542-581).
//
// Outputs the alignment as op codes, reversed in place before returning:
//   0 = match/mismatch (consume a_i and b_j)
//   1 = gap in seq_1   (consume b_j)        [level Ix]
//   2 = gap in seq_2   (consume a_i)        [level Iy]
// ops must have room for m + n entries.  Returns the op count.
int64_t ga_traceback_walk(const uint8_t* moves, int64_t stride, int64_t m,
                          int64_t n, int32_t start_level, uint8_t* ops) {
  int64_t i = m, j = n, k = 0;
  int32_t level = start_level;
  while (i > 0 || j > 0) {
    if (i == 0) {
      ops[k++] = 1;
      --j;
      continue;
    }
    if (j == 0) {
      ops[k++] = 2;
      --i;
      continue;
    }
    uint8_t code = moves[i * stride + j];
    if (level == 0) {
      ops[k++] = 0;
      level = code & 3;
      --i;
      --j;
    } else if (level == 1) {
      ops[k++] = 1;
      level = (code >> 2) & 3;
      --j;
    } else {
      ops[k++] = 2;
      level = (code >> 4) & 3;
      --i;
    }
  }
  for (int64_t a = 0, b = k - 1; a < b; ++a, --b) {
    uint8_t t = ops[a];
    ops[a] = ops[b];
    ops[b] = t;
  }
  return k;
}

// Render op codes into the three alignment lines (reference
// globaligner.py:688-753: '|' match, '*' mismatch, ' ' gap middle glyphs,
// '-' gap char).  Buffers out_1/mid/out_2 must have room for n_ops chars.
void ga_render_ops(const uint8_t* ops, int64_t n_ops, const char* seq_1,
                   const char* seq_2, char* out_1, char* mid, char* out_2) {
  int64_t i = 0, j = 0;
  for (int64_t k = 0; k < n_ops; ++k) {
    switch (ops[k]) {
      case 0: {
        char a = seq_1[i++], b = seq_2[j++];
        out_1[k] = a;
        out_2[k] = b;
        mid[k] = (a == b) ? '|' : '*';
        break;
      }
      case 1:
        out_1[k] = '-';
        out_2[k] = seq_2[j++];
        mid[k] = ' ';
        break;
      default:
        out_1[k] = seq_1[i++];
        out_2[k] = '-';
        mid[k] = ' ';
        break;
    }
  }
}

// ---------------------------------------------------------------------------
// Bucketizer
// ---------------------------------------------------------------------------

// Round each length up to the bucket grid: max(q, q * ceil(len / q))
// (mirrors batch.bucket_length).
void ga_bucket_lengths(const int64_t* lengths, int64_t n, int64_t quantum,
                       int64_t* out) {
  for (int64_t k = 0; k < n; ++k) {
    int64_t q = quantum * ((lengths[k] + quantum - 1) / quantum);
    out[k] = q < quantum ? quantum : q;
  }
}

}  // extern "C"
