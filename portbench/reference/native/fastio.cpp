// Native host IO for metamdbg_tpu — the role of the reference's embedded
// htslib/kseq (src/Commons.hpp:82, ReadParserParallel): streaming
// FASTA/FASTQ(.gz) decoding into flat buffers that the Python/JAX layer maps
// to padded device batches without per-read Python overhead.
//
// Exposed as a small C ABI (ctypes-friendly):
//   fastio_open(path)            -> handle
//   fastio_next_batch(handle, max_reads, max_bases, ...) -> counts
//   fastio_close(handle)
//
// Build: g++ -O3 -shared -fPIC -o libfastio.so fastio.cpp -lz

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  gzFile file = nullptr;
  std::string pending;   // carry-over line buffer
  bool eof = false;

  bool getline(std::string& out) {
    out.clear();
    char buf[65536];
    while (true) {
      if (!pending.empty()) {
        size_t nl = pending.find('\n');
        if (nl != std::string::npos) {
          out.append(pending, 0, nl);
          pending.erase(0, nl + 1);
          if (!out.empty() && out.back() == '\r') out.pop_back();
          return true;
        }
        out += pending;
        pending.clear();
      }
      int n = gzread(file, buf, sizeof(buf));
      if (n <= 0) {
        eof = true;
        if (!out.empty()) {
          if (out.back() == '\r') out.pop_back();
          return true;
        }
        return false;
      }
      pending.assign(buf, n);
    }
  }
};

}  // namespace

extern "C" {

void* fastio_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  auto* r = new Reader();
  r->file = f;
  return r;
}

void fastio_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r) {
    gzclose(r->file);
    delete r;
  }
}

// Reads up to max_reads records or max_bases total sequence bytes.
// seq_buf/qual_buf receive concatenated sequences/qualities;
// lengths[i] the per-read length (quality length equals sequence length for
// fastq, 0 for fasta records). Returns number of reads decoded (0 = EOF).
int64_t fastio_next_batch(void* handle, int64_t max_reads, int64_t max_bases,
                          uint8_t* seq_buf, uint8_t* qual_buf,
                          int64_t* lengths, uint8_t* has_qual) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;

  int64_t n_reads = 0;
  int64_t used = 0;
  std::string line, seq;

  while (n_reads < max_reads) {
    if (!r->getline(line)) break;
    if (line.empty()) continue;

    if (line[0] == '@') {  // fastq record
      if (!r->getline(seq)) break;
      std::string plus, qual;
      r->getline(plus);
      r->getline(qual);
      if (used + (int64_t)seq.size() > max_bases && n_reads > 0) {
        // push back: cheap since we re-parse the header next call
        r->pending = line + "\n" + seq + "\n" + plus + "\n" + qual + "\n" +
                     r->pending;
        break;
      }
      std::memcpy(seq_buf + used, seq.data(), seq.size());
      std::memcpy(qual_buf + used, qual.data(), qual.size());
      lengths[n_reads] = (int64_t)seq.size();
      has_qual[n_reads] = 1;
      used += (int64_t)seq.size();
      n_reads += 1;
    } else if (line[0] == '>') {  // fasta record (multi-line)
      seq.clear();
      std::string next;
      while (true) {
        if (!r->getline(next)) break;
        if (!next.empty() && (next[0] == '>' || next[0] == '@')) {
          r->pending = next + "\n" + r->pending;
          break;
        }
        seq += next;
        if (r->eof && r->pending.empty()) break;
      }
      if (used + (int64_t)seq.size() > max_bases && n_reads > 0) {
        r->pending = line + "\n" + seq + "\n" + r->pending;
        break;
      }
      std::memcpy(seq_buf + used, seq.data(), seq.size());
      std::memset(qual_buf + used, 0, seq.size());
      lengths[n_reads] = (int64_t)seq.size();
      has_qual[n_reads] = 0;
      used += (int64_t)seq.size();
      n_reads += 1;
    }
  }
  return n_reads;
}

}  // extern "C"
